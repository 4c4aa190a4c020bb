"""Export a port checkpoint as an HF-format torch model directory.

The port's ``tools/export_hf.py``: the LoRA factors are merged into the base
weights in full f32 first (``core.relora.merged_params``), so the output
loads into transformers' ``LlamaForCausalLM`` / ``GPTNeoXForCausalLM``, and
into the port's models through ``models/warm_start.graft_base_weights``.
``--pruned`` applies the checkpoint's ``prune_mask.npz`` sidecar to the
merged weights (pruned positions exactly 0) and records the sparsity and
the mask checksum in ``config.json`` under ``relora_tpu_pruning``; a
checkpoint without a sidecar, or a mask that does not fit, is refused.

    python -m relora_tpu_torch.tools.export_hf --checkpoint ckpts/model_20000 \\
        --model_config llama_250m --out export/llama_250m_relora [--dtype bf16] [--pruned]

The merge and the mask run on ``--device`` (default ``cuda``; ``cpu``
rehearses it anywhere).
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None) -> str:
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--model_config", required=True)
    p.add_argument("--out", required=True)
    p.add_argument(
        "--dtype",
        choices=["f32", "bf16"],
        default="f32",
        help="storage dtype of the exported tensors (merge math stays f32)",
    )
    p.add_argument(
        "--pruned",
        action="store_true",
        help="apply the checkpoint's prune_mask.npz sidecar to the merged "
        "weights before export (pruned positions stay exactly zero) and record "
        "sparsity + mask checksum in the output config; errors if the "
        "checkpoint has no mask or the mask does not fit the weights",
    )
    p.add_argument("--device", default="cuda", help="where the merge and the mask run")
    args = p.parse_args(argv)

    import torch

    from relora_tpu_torch import resolve_device
    from relora_tpu_torch.config.model import load_model_config
    from relora_tpu_torch.core.relora import merged_params
    from relora_tpu_torch.models.warm_start import params_to_hf
    from relora_tpu_torch.train.checkpoint import load_lora_spec, restore_params_host

    device = resolve_device(args.device)
    cfg = load_model_config(args.model_config)
    params = {k: v.to(device) for k, v in restore_params_host(args.checkpoint).items()}
    spec = load_lora_spec(args.checkpoint)
    if spec is not None:
        params = merged_params(params, spec)
        print(f"merged LoRA factors (r={spec.r}) into base weights")

    pruning_block = None
    if args.pruned:
        # apply_mask raises PruneMaskMismatchError (naming the module) on a
        # missing module or a shape mismatch: a mask of another architecture
        # fails the export instead of shipping dense weights
        from relora_tpu_torch.compress.prune import apply_mask, load_mask, mask_checksum, sparsity_stats

        mask, _ = load_mask(args.checkpoint, device=device)
        if mask is None:
            raise SystemExit(
                f"--pruned: {args.checkpoint} has no prune_mask.npz sidecar "
                "(not a prune-retrain checkpoint?)"
            )
        params = apply_mask(params, mask)
        stats = sparsity_stats(mask)
        pruning_block = {
            "sparsity": round(stats["sparsity"], 6),
            "mask_crc32": mask_checksum(mask),
        }
        print(f"applied prune mask: {stats['sparsity']:.1%} sparsity")

    sd = params_to_hf(params, cfg)
    os.makedirs(args.out, exist_ok=True)
    out_dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    torch.save({k: v.float().to(out_dtype).cpu().contiguous() for k, v in sd.items()},
               os.path.join(args.out, "pytorch_model.bin"))
    hf_config = {
        "architectures": ["LlamaForCausalLM" if cfg.family == "llama" else "GPTNeoXForCausalLM"],
        "model_type": "llama" if cfg.family == "llama" else "gpt_neox",
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_hidden_layers,
        "num_attention_heads": cfg.num_attention_heads,
        "num_key_value_heads": cfg.num_attention_heads,
        "max_position_embeddings": cfg.max_sequence_length,
        "rms_norm_eps": cfg.rms_norm_eps,
        "layer_norm_eps": cfg.layer_norm_eps,
        "rotary_pct": cfg.rotary_pct,
        "rope_theta": cfg.rotary_emb_base,
        "use_parallel_residual": cfg.use_parallel_residual,
        "tie_word_embeddings": cfg.tie_word_embeddings,
        "bos_token_id": cfg.bos_token_id,
        "eos_token_id": cfg.eos_token_id,
        "torch_dtype": "bfloat16" if args.dtype == "bf16" else "float32",
    }
    if pruning_block is not None:
        hf_config["relora_tpu_pruning"] = pruning_block
    with open(os.path.join(args.out, "config.json"), "w") as f:
        json.dump(hf_config, f, indent=2)
    n = sum(v.numel() for v in sd.values())
    print(f"wrote {len(sd)} tensors ({n/1e6:.1f}M params) to {args.out}")
    return args.out


if __name__ == "__main__":
    main()

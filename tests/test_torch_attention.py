"""The PyTorch port's paged attention against the JAX package's kernels.

On the CPU the port's ``paged_decode_attention`` / ``packed_paged_attention``
run their plain twins (the CUDA kernels run only on the card, where
``chip_smoke.py`` holds them to these twins).  Here the twins are held to the
JAX Pallas kernels run in interpret mode, on the same numpy inputs: f32 and
int8 pools, grouped-query heads, S in {1, 5}, both position forms, and pad
rows.  Tolerance 1e-5: both sides compute in f32 but sum in another order
(online softmax over pages vs one softmax over the gathered row).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relora_tpu.ops import attention as jax_attention
from relora_tpu_torch.ops import attention as torch_attention
from relora_tpu_torch.ops.attention_dispatch import packed_attention, paged_attention

pytestmark = pytest.mark.torch_port

TOL = 1e-5


def _quantize(pool):
    """Per-(page, kv_head) absmax int8 codes and f32 scales."""
    scale = np.maximum(np.abs(pool).max(axis=(1, 3)) / 127.0, 1e-12).astype(np.float32)
    codes = np.clip(np.round(pool / scale[:, None, :, None]), -127, 127).astype(np.int8)
    return codes, scale


def _pool_case(seed, *, B=3, S=1, heads=4, kv_heads=2, head_dim=8, page_size=4, W=3,
               int8=False):
    """Rows own disjoint pages (not in pool order) at staggered positions,
    with garbage in the null page and in never-referenced pages."""
    rng = np.random.default_rng(seed)
    num_pages = B * W + 3
    q = rng.standard_normal((B, S, heads, head_dim)).astype(np.float32)
    pool_k = rng.standard_normal((num_pages, page_size, kv_heads, head_dim)).astype(np.float32)
    pool_v = rng.standard_normal((num_pages, page_size, kv_heads, head_dim)).astype(np.float32)
    bt = (rng.permutation(B * W) + 1).reshape(B, W).astype(np.int32)
    base = np.linspace(0, W * page_size - S, B).astype(np.int32)
    pos = np.minimum(base[:, None] + np.arange(S)[None, :], W * page_size - 1).astype(np.int32)
    scales = {}
    if int8:
        pool_k, ks = _quantize(pool_k)
        pool_v, vs = _quantize(pool_v)
        scales = dict(k_scale=ks, v_scale=vs)
    return q, pool_k, pool_v, bt, pos, scales


def _jax(fn, *args, **kwargs):
    args = [jnp.asarray(a) for a in args]
    kwargs = {k: jnp.asarray(v) for k, v in kwargs.items()}
    return np.asarray(fn(*args, **kwargs, interpret=True))


def _torch(fn, *args, **kwargs):
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    kwargs = {k: torch.from_numpy(v) for k, v in kwargs.items()}
    return fn(*args, **kwargs).numpy()


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("S", [1, 5])
@pytest.mark.parametrize("heads,kv_heads", [(4, 4), (8, 2)], ids=["mha", "gqa"])
def test_paged_decode_matches_jax_kernel(S, int8, heads, kv_heads):
    q, pk, pv, bt, pos, scales = _pool_case(S, S=S, heads=heads, kv_heads=kv_heads, int8=int8)
    want = _jax(jax_attention.paged_decode_attention, q, pk, pv, bt, pos, **scales)
    got = _torch(torch_attention.paged_decode_attention, q, pk, pv, bt, pos, **scales)
    assert got.shape == want.shape == q.shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("form", ["flat", "column"])
def test_paged_decode_broadcast_positions(form):
    """(B,) and (B, 1) positions: every query token sees one frontier."""
    q, pk, pv, bt, pos, _ = _pool_case(7, S=5)
    pos1 = pos[:, :1] if form == "column" else pos[:, 0]
    want = _jax(jax_attention.paged_decode_attention, q, pk, pv, bt, pos1)
    got = _torch(torch_attention.paged_decode_attention, q, pk, pv, bt, pos1)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def _packed_case(seed, *, int8=False, heads=8, kv_heads=2):
    """A packed window as the scheduler builds it: decode tokens of two rows,
    a prefill run of a third, then pad tokens on the all-null last row at the
    null position (one past the real table columns)."""
    q, pk, pv, bt, _, scales = _pool_case(seed, B=3, S=1, heads=heads,
                                          kv_heads=kv_heads, int8=int8)
    W, ps = bt.shape[1], pk.shape[1]
    tables = np.zeros((4, W + 1), np.int32)
    tables[:3, :W] = bt
    row_map = np.array([0, 1, 2, 2, 2, 2, 3, 3], np.int32)
    positions = np.array([5, 11, 0, 1, 2, 3, W * ps, W * ps], np.int32)
    T = len(row_map)
    qp = np.random.default_rng(seed + 1).standard_normal((1, T, heads, q.shape[-1]))
    return qp.astype(np.float32), pk, pv, tables, row_map, positions, scales


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("heads,kv_heads", [(4, 4), (8, 2)], ids=["mha", "gqa"])
def test_packed_matches_jax_kernel(int8, heads, kv_heads):
    q, pk, pv, tables, rm, pos, scales = _packed_case(3, int8=int8, heads=heads, kv_heads=kv_heads)
    want = _jax(jax_attention.packed_paged_attention, q, pk, pv, tables, rm, pos, **scales)
    got = _torch(torch_attention.packed_paged_attention, q, pk, pv, tables, rm, pos, **scales)
    assert np.isfinite(got).all()  # pad tokens included
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_dispatch_arms_agree_on_cpu():
    """The naive arm and the fused arm's plain twin give the same result;
    ``auto`` on CPU tensors picks the naive arm."""
    q, pk, pv, bt, pos, _ = (torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                             for a in _pool_case(2, S=1))
    naive = paged_attention(q, pk, pv, bt, pos, arm="naive")
    fused = paged_attention(q, pk, pv, bt, pos, arm="paged_decode")
    auto = paged_attention(q, pk, pv, bt, pos)
    torch.testing.assert_close(fused, naive, atol=TOL, rtol=0)
    assert torch.equal(auto, naive)
    qp, pk, pv, tables, rm, posp, _ = (
        torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in _packed_case(4)
    )
    torch.testing.assert_close(
        packed_attention(qp, pk, pv, tables, rm, posp, arm="packed"),
        packed_attention(qp, pk, pv, tables, rm, posp, arm="naive"),
        atol=TOL, rtol=0,
    )
    with pytest.raises(ValueError, match="unservable arm"):
        paged_attention(q, pk, pv, bt, pos, arm="flash")


def test_wrappers_never_fall_back_off_the_cpu():
    """A tensor that is not on the CPU goes to the kernel path, which raises
    for a non-CUDA device instead of running the plain version."""
    q, pk, pv, bt, pos, _ = _pool_case(1)
    meta = lambda a: torch.empty(a.shape, dtype=torch.from_numpy(a).dtype, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        torch_attention.paged_decode_attention(meta(q), meta(pk), meta(pv), meta(bt), meta(pos))
    qp, pk, pv, tables, rm, posp, _ = _packed_case(1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        torch_attention.packed_paged_attention(
            meta(qp), meta(pk), meta(pv), meta(tables), meta(rm), meta(posp)
        )
    assert torch_attention.paged_decode_attention.launches == 0
    assert torch_attention.packed_paged_attention.launches == 0


def test_scales_must_come_together():
    q, pk, pv, bt, pos, scales = _pool_case(6, int8=True)
    with pytest.raises(ValueError, match="k_scale"):
        _torch(torch_attention.paged_decode_attention, q, pk, pv, bt, pos,
               k_scale=scales["k_scale"])


# ------------------------------------------------ kernel 1's split walk


@pytest.mark.parametrize("W,ps", [(1, 16), (3, 4), (64, 16), (65, 16), (20, 16), (7, 1),
                                  (80, 4), (4, 200), (33, 128)])
def test_paged_decode_schedule_covers_every_page_once(W, ps):
    """The partitions of a row's table cover each of its W pages exactly
    once, in order, at most SPLIT_KEYS keys apiece (one page where a page is
    longer), and the schedule is a function of (W, ps) alone: it has no
    batch, position or head-dim argument, so a row's partials cannot depend
    on the rows it decodes with."""
    import inspect

    sched = torch_attention.paged_decode_schedule
    assert list(inspect.signature(sched).parameters) == ["table_width", "page_size"]
    pp, n_part = sched(W, ps)
    assert (pp, n_part) == sched(W, ps)
    covered = [w for p in range(n_part) for w in range(p * pp, min(W, (p + 1) * pp))]
    assert covered == list(range(W))
    assert all(p * pp < W for p in range(n_part))  # no empty partition
    assert pp * ps <= max(torch_attention.SPLIT_KEYS, ps)
    G, H = 5, 48
    assert torch_attention.paged_decode_scratch_floats(8, 16, n_part, G, H) == (
        8 * 16 * n_part * G * (H + 2))


def _split_walk(q, pk, pv, bt, pos, k_scale=None, v_scale=None):
    """Kernel 1's split walk in plain f32 numpy: per partition of the row's
    table (:func:`paged_decode_schedule`) over the keys the row can see, the
    partial (m, l, acc) of each query (-1e30 masked logits, masked p); the
    partials merged in partition order; out = acc / max(l, 1e-30)."""
    f32 = np.float32
    B, S, N, H = q.shape
    ps, n_kv = pk.shape[1], pk.shape[2]
    W, g = bt.shape[1], N // n_kv
    pp, _ = torch_attention.paged_decode_schedule(W, ps)
    tpp = pp * ps
    out = np.zeros(q.shape, f32)
    for b in range(B):
        walk = min(W * ps, int(pos[b].max()) + 1)
        for j in range(n_kv):
            for h in range(g):
                for s in range(S):
                    qv = q[b, s, j * g + h].astype(f32)
                    parts = []
                    for start in range(0, walk, tpp):
                        t = np.arange(start, min(start + tpp, walk))
                        pages, rows = bt[b, t // ps], t % ps
                        k = pk[pages, rows, j].astype(f32)
                        v = pv[pages, rows, j].astype(f32)
                        if k_scale is not None:
                            k = k * k_scale[pages, j][:, None]
                            v = v * v_scale[pages, j][:, None]
                        vis = t <= pos[b, s]
                        x = np.where(vis, (k @ qv) * f32(H ** -0.5), f32(-1e30)).astype(f32)
                        m = x.max()
                        e = np.where(vis, np.exp(x - m), f32(0)).astype(f32)
                        parts.append((m, e.sum(dtype=f32), e @ v))
                    mx = max((m for m, _, _ in parts), default=f32(-1e30))
                    l, acc = f32(0), np.zeros(H, f32)
                    for m, lp, ap in parts:
                        w = np.exp(f32(m - mx))
                        l, acc = l + lp * w, acc + ap * w
                    out[b, s, j * g + h] = acc / max(l, f32(1e-30))
    return out


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("S", [1, 5])
@pytest.mark.parametrize("heads,kv_heads", [(4, 4), (8, 2)], ids=["mha", "gqa"])
def test_split_walk_merge_matches_twin_and_jax_kernel(S, int8, heads, kv_heads):
    """The split schedule evaluated partition by partition and merged in
    order equals the plain twin within 1e-6 and the JAX interpret-mode
    kernel within TOL, over three partitions a row (20 pages of 16), rows
    ending mid-partition, and a pad row (every position -1: 0 from the twin
    and the split walk; the JAX kernel divides 0 by 0 there, so its pad row
    is not compared)."""
    q, pk, pv, bt, pos, scales = _pool_case(11 + S, B=3, S=S, heads=heads, kv_heads=kv_heads,
                                            page_size=16, W=20, int8=int8)
    q = np.concatenate([q, q[:1]])
    bt = np.concatenate([bt, bt[:1]])
    pos = np.concatenate([pos, np.full((1, S), -1, np.int32)])  # row 3: a pad row
    assert torch_attention.paged_decode_schedule(20, 16)[1] == 3
    split = _split_walk(q, pk, pv, bt, pos, scales.get("k_scale"), scales.get("v_scale"))
    twin = _torch(torch_attention.paged_decode_attention_plain, q, pk, pv, bt, pos, **scales)
    np.testing.assert_allclose(split, twin, atol=1e-6, rtol=0)
    assert (split[3] == 0).all() and (twin[3] == 0).all()
    want = _jax(jax_attention.paged_decode_attention, q[:3], pk, pv, bt[:3], pos[:3], **scales)
    np.testing.assert_allclose(split[:3], want, atol=TOL, rtol=0)

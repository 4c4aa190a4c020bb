"""Kernel 2's redesign (packed paged attention) as pure functions on the CPU.

The CUDA path (``csrc/paged_attention.cu``: ``packed_tile_kernel`` for the
window's query tiles of two tokens or more, kernel 1's split pair for every
other token) runs only on the card, where ``chip_smoke.py`` holds it to
``packed_paged_attention_plain`` and checks it bit for bit against the same
run alone.  Here the run grouping and tile schedule
(:func:`packed_tile_schedule`, :func:`packed_tokens_per_tile`) are tested
as pure functions, and a tile-by-tile evaluation in numpy (a multi-token
tile: an online softmax over key tiles of 64 keys, 32 past a padded head of
128, every row masked at its own position; a one-token tile: partitions of
:func:`packed_walk_schedule` merged in order, as kernel 1's pair does) is held to the plain twin and to the JAX
package's packed kernel run in interpret mode, on the same numpy inputs,
at H = 48 and H = 256.  Tolerance 1e-5: f32 on both sides, sums in another
order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relora_tpu.ops import attention as jax_attention
from relora_tpu_torch.ops import attention as A

pytestmark = pytest.mark.torch_port

TOL = 1e-5


# (row_map, positions, tokens per tile) -> tiles as (first token, count)
SCHEDULES = {
    "run_crossing_a_tile_edge": ([0] * 6, [14, 15, 16, 17, 18, 19], 16, [(0, 2), (2, 4)]),
    "single_token_runs": ([0, 1, 2], [5, 9, 3], 16, [(0, 1), (1, 1), (2, 1)]),
    "run_longer_than_a_tile": ([3] * 40, list(range(40)), 16, [(0, 16), (16, 16), (32, 8)]),
    "pads_on_the_null_row": ([0, 0, 4, 4, 4], [7, 8, 64, 64, 64], 16,
                             [(0, 2), (2, 1), (3, 1), (4, 1)]),
    "rows_back_to_back": ([0, 0, 1, 1], [3, 4, 5, 6], 16, [(0, 2), (2, 2)]),
    "position_gap_in_one_row": ([2, 2, 2, 2], [3, 4, 9, 10], 16, [(0, 2), (2, 2)]),
    "gqa_four_heads_a_kv_head": ([1] * 20, list(range(10, 30)), 64 // 4,
                                 [(0, 6), (6, 14)]),
    "tensor_cores_off": ([0] * 4, [0, 1, 2, 3], 0, [(0, 1), (1, 1), (2, 1), (3, 1)]),
}


@pytest.mark.parametrize("case", list(SCHEDULES))
def test_tile_schedule(case):
    rm, pos, qt, want = SCHEDULES[case]
    assert A.packed_tile_schedule(rm, pos, qt) == want


def _window(rng, W, ps):
    """A scheduler-like window: decode tokens, a prefill run, more decode
    tokens, then pads on the null row at the null position."""
    n = int(rng.integers(3, 50))
    start = int(rng.integers(0, W * ps - n))
    rm = [0, 1] + [2] * n + [3] + [5, 5]
    pos = [int(rng.integers(0, W * ps)), int(rng.integers(0, W * ps))]
    pos += list(range(start, start + n)) + [int(rng.integers(0, W * ps))] + [W * ps] * 2
    return rm, pos


@pytest.mark.parametrize("qt", [0, 2, 16, 64])
def test_tile_schedule_depends_on_the_run_alone(qt):
    """Every token lies in one tile; a tile never spans two runs nor more
    than qt tokens; and a run's tiles are the same whether it is scheduled
    alone or inside a window (what makes a token's output batch-invariant)."""
    rng = np.random.default_rng(qt)
    for _ in range(20):
        rm, pos = _window(rng, W=20, ps=8)
        tiles = A.packed_tile_schedule(rm, pos, qt)
        assert [t for t0, c in tiles for t in range(t0, t0 + c)] == list(range(len(rm)))
        for t0, c in tiles:
            assert c <= max(qt, 1)
            assert all(rm[t] == rm[t0] and pos[t] == pos[t0] + (t - t0) for t in range(t0, t0 + c))
        run = [t for t in range(len(rm)) if rm[t] == 2]
        alone = A.packed_tile_schedule([rm[t] for t in run], [pos[t] for t in run], qt)
        assert [(t0 - run[0], c) for t0, c in tiles if rm[t0] == 2] == alone


# (q dtype, pool dtype, heads, kv heads, head_dim, aligned) -> tokens per tile
TOKENS_PER_TILE = {
    "bf16_pool_g1": (torch.bfloat16, torch.bfloat16, 16, 16, 48, True, 64),
    "int8_pool_g4": (torch.bfloat16, torch.int8, 16, 4, 64, True, 16),
    "bf16_pool_H256": (torch.bfloat16, torch.bfloat16, 8, 8, 256, True, 64),
    "f32": (torch.float32, torch.float32, 16, 16, 48, True, 0),
    "f32_q_bf16_pool": (torch.float32, torch.bfloat16, 16, 16, 48, True, 0),
    "bf16_q_f32_pool": (torch.bfloat16, torch.float32, 16, 16, 48, True, 0),
    "H_50": (torch.bfloat16, torch.bfloat16, 4, 2, 50, True, 0),
    "unaligned": (torch.bfloat16, torch.bfloat16, 16, 16, 48, False, 0),
    "g_64": (torch.bfloat16, torch.bfloat16, 64, 1, 64, True, 0),
    "g_32": (torch.bfloat16, torch.bfloat16, 64, 2, 64, True, 2),
}


@pytest.mark.parametrize("W,ps", [(1, 16), (65, 16), (10, 8), (7, 1), (3, 600)])
def test_packed_walk_schedule_covers_every_page_once(W, ps):
    """Kernel 2's one-token partitions cover a row's W pages once, in order,
    at most PACKED_SPLIT_KEYS keys apiece (one page where a page is
    longer), from (W, ps) alone."""
    import inspect

    sched = A.packed_walk_schedule
    assert list(inspect.signature(sched).parameters) == ["table_width", "page_size"]
    pp, n_part = sched(W, ps)
    assert [w for p in range(n_part) for w in range(p * pp, min(W, (p + 1) * pp))] == list(range(W))
    assert all(p * pp < W for p in range(n_part))
    assert pp * ps <= max(A.PACKED_SPLIT_KEYS, ps)


@pytest.mark.parametrize("case", list(TOKENS_PER_TILE))
def test_tokens_per_tile_rule(case):
    *args, want = TOKENS_PER_TILE[case]
    assert A.packed_tokens_per_tile(*args) == want


def _softmax_walk(qv, k, v, visible, starts, scale):
    """(m, l, acc) of query rows qv (R, H) over keys k, v (C, H), key tile by
    key tile at ``starts`` (each to the next start), -inf masked logits,
    masked p; a key tile a row cannot see leaves its state as it was."""
    f32 = np.float32
    R = qv.shape[0]
    m, l, acc = np.full(R, -np.inf, f32), np.zeros(R, f32), np.zeros((R, qv.shape[1]), f32)
    bounds = list(starts) + [k.shape[0]]
    for a, b in zip(bounds[:-1], bounds[1:]):
        vis = visible[:, a:b]
        x = np.where(vis, (qv @ k[a:b].T) * f32(scale), -np.inf).astype(f32)
        m_new = np.maximum(m, x.max(axis=1))
        base = np.where(np.isfinite(m_new), m_new, f32(0))
        alpha = np.exp(m - base).astype(f32)
        p = np.where(vis, np.exp(x - base[:, None]), f32(0)).astype(f32)
        l = l * alpha + p.sum(axis=1, dtype=f32)
        acc = acc * alpha[:, None] + p @ v[a:b]
        m = m_new
    return m, l, acc


def _tile_eval(q, pk, pv, tables, rm, pos, k_scale=None, v_scale=None):
    """Kernel 2's schedule evaluated tile by tile in f32 numpy."""
    f32 = np.float32
    _, T, N, H = q.shape
    ps, n_kv = pk.shape[1], pk.shape[2]
    W, g = tables.shape[1], N // n_kv
    scale = H**-0.5
    qt = A.PACKED_TILE_ROWS // g  # the tensor-core rule on a bf16 call
    kt = 64 if -(-H // 16) * 16 <= 128 else 32
    pp, _ = A.packed_walk_schedule(W, ps)
    out = np.zeros(q.shape, f32)
    for t0, c in A.packed_tile_schedule(rm, pos, qt):
        walk = min(W * ps, int(pos[t0 + c - 1]) + 1)
        keys = np.arange(walk)
        pages, rows = tables[rm[t0], keys // ps], keys % ps
        rpos = np.repeat(np.asarray(pos[t0:t0 + c]), g)  # rows token-major: token * g + head
        visible = keys[None, :] <= rpos[:, None]
        # a tile of two tokens or more: key tiles of kt; one token: kernel 1's partitions
        starts = range(0, walk, kt) if c >= 2 else range(0, walk, pp * ps)
        for j in range(n_kv):
            k, v = pk[pages, rows, j].astype(f32), pv[pages, rows, j].astype(f32)
            if k_scale is not None:
                k, v = k * k_scale[pages, j][:, None], v * v_scale[pages, j][:, None]
            qv = q[0, t0:t0 + c, j * g:(j + 1) * g].reshape(c * g, H).astype(f32)
            if c >= 2:
                _, l, acc = _softmax_walk(qv, k, v, visible, starts, scale)
            else:  # partitions, each its own softmax, merged in order
                parts = [_softmax_walk(qv, k[s:s + pp * ps], v[s:s + pp * ps],
                                       visible[:, s:s + pp * ps], [0], scale) for s in starts]
                mx = np.max([pm for pm, _, _ in parts], axis=0) if parts else np.full(g, -np.inf, f32)
                base = np.where(np.isfinite(mx), mx, f32(0))
                l, acc = np.zeros(g, f32), np.zeros((g, H), f32)
                for pm, pl_, pa in parts:
                    w = np.exp(pm - base).astype(f32)
                    l, acc = l + pl_ * w, acc + pa * w[:, None]
            o = acc / np.maximum(l, f32(1e-30))[:, None]
            out[0, t0:t0 + c, j * g:(j + 1) * g] = o.reshape(c, g, H)
    return out


def _quantize(pool):
    scale = np.maximum(np.abs(pool).max(axis=(1, 3)) / 127.0, 1e-12).astype(np.float32)
    codes = np.clip(np.round(pool / scale[:, None, :, None]), -127, 127).astype(np.int8)
    return codes, scale


def _case(seed, *, heads, kv_heads, head_dim, int8, ps=64, W=10):
    """Two decode tokens, a 30-token prefill run at positions 50..79 (it
    crosses a tile edge at 64 tokens a tile and at 16, four heads a kv
    head), another decode token, and two pads on the all-null last row at
    the null position.  640 keys a row: a pad's walk spans two partitions."""
    rng = np.random.default_rng(seed)
    rows = 4
    num_pages = rows * W + 2
    pk = rng.standard_normal((num_pages, ps, kv_heads, head_dim)).astype(np.float32)
    pv = rng.standard_normal((num_pages, ps, kv_heads, head_dim)).astype(np.float32)
    tables = np.zeros((rows + 1, W + 1), np.int32)
    tables[:rows, :W] = (rng.permutation(rows * W) + 1).reshape(rows, W)
    rm = [0, 1] + [2] * 30 + [3] + [rows] * 2
    pos = [17, 71] + list(range(50, 80)) + [5] + [W * ps] * 2
    q = rng.standard_normal((1, len(rm), heads, head_dim)).astype(np.float32)
    scales = {}
    if int8:
        pk, ks = _quantize(pk)
        pv, vs = _quantize(pv)
        scales = dict(k_scale=ks, v_scale=vs)
    return q, pk, pv, tables, np.asarray(rm, np.int32), np.asarray(pos, np.int32), scales


CASES = {
    "H48_f32_g1": dict(heads=4, kv_heads=4, head_dim=48, int8=False),
    "H48_int8_g1": dict(heads=4, kv_heads=4, head_dim=48, int8=True),
    "H48_f32_gqa": dict(heads=8, kv_heads=2, head_dim=48, int8=False),
    "H48_int8_gqa": dict(heads=8, kv_heads=2, head_dim=48, int8=True),
    "H256_f32_g1": dict(heads=2, kv_heads=2, head_dim=256, int8=False),
    "H256_int8_gqa": dict(heads=8, kv_heads=2, head_dim=256, int8=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_tile_evaluation_matches_twin_and_jax_kernel(case):
    q, pk, pv, tables, rm, pos, scales = _case(3, **CASES[case])
    qt = A.PACKED_TILE_ROWS // (CASES[case]["heads"] // CASES[case]["kv_heads"])
    tiles = A.packed_tile_schedule(rm, pos, qt)
    assert any(c >= 2 for _, c in tiles) and any(c == 1 for _, c in tiles)
    got = _tile_eval(q, pk, pv, tables, rm, pos, scales.get("k_scale"), scales.get("v_scale"))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    twin = A.packed_paged_attention_plain(t(q), t(pk), t(pv), t(tables), t(rm), t(pos),
                                          **{k: t(v) for k, v in scales.items()}).numpy()
    assert np.isfinite(got).all()  # pads included
    np.testing.assert_allclose(got, twin, atol=TOL, rtol=0)
    want = np.asarray(jax_attention.packed_paged_attention(
        *(jnp.asarray(a) for a in (q, pk, pv, tables, rm, pos)),
        **{k: jnp.asarray(v) for k, v in scales.items()}, interpret=True))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)

"""The order of operations of K5b, the attention forward on bf16 q, k and
v (``csrc/attn_fwd_bf16.cu``), on the CPU.

The kernel runs only on the card. A block takes a 128-row query tile of
one (b, h), the query tile the slow index of its 1-D grid, the last first;
two warpgroups of 64 rows each walk the block's 128-key tiles of k and v,
computing only the tiles that a row of theirs sees (the others they wait
for and release). Per tile: S = q.k^T as a sum of 16-feature k-steps in
f32; the online softmax with a running max per row in log2 units (the
max of the raw logits times log2(e) / sqrt(dh); ``attn::visible`` masking
the tiles that cross the band or ``len_b``), p = 2^(s log2(e) / sqrt(dh) -
m) with the multiply and subtract fused;
the unnormalised probabilities rounded to bf16 as P.V's A operand, with
f32 sums; o = acc / l in f32, lse = (m + log2 l) ln 2, and a row that sees
no key 0 with lse +inf. At dh 96 every tile is two 64-column slabs, the
second with zero columns 96-127: q.k^T reads 6 k-steps, P.V accumulates 128
columns and writes 96.

:func:`emulated_k5b` repeats that order in plain torch. The tests hold it
to the plain bf16 attention (``flash_attention_reference`` with
``compute_dtype`` bf16) within ``BF16_ULPS`` bf16 ulps of the largest
|value|, nearer in the mean than the f32 plain version (``K5B_CLOSER``) and
within ``K5B_O_OF_CONTROL`` times the largest |error| of the plain version
in f32 on the same bf16 q, k, v, plus ``F32_SLACK`` of the largest |value|
(as the card checks hold the kernel), to
the JAX package's exact bf16
attention, to itself without the zero columns (bit for bit), and check
that the kernel's tile ranges visit every visible (query, key) pair in
exactly one tile of one warpgroup.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morgana_tpu.ops import attention as jattention

from morgana_tpu_torch.ops import flash_attention as fa

BF16_ULPS = 4         # tests/test_torch_kernels.py, chip_smoke.py
K5B_CLOSER = 1        # tests/test_torch_kernels.py, chip_smoke.py
K5B_O_OF_CONTROL = 2  # tests/test_torch_kernels.py, chip_smoke.py
F32_SLACK = 2.0 ** -20  # of the largest |value|: the f32 sums alone (T = 1)
MAX_RTOL = 2.0 ** -8  # tests/test_torch_bf16.py
ROWS = 128            # query rows a block (kRows)
GROUP = 64            # rows a consumer warpgroup
KEYS = 128            # keys a streamed tile (kKeys)
K_STEP = 16           # the depth of wgmma m64nNk16
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


def round_bf16(x):
    return x.to(torch.bfloat16).float()


def grid_order(time_steps, batch_heads):
    """(q0, bh) of each block of the 1-D grid, in block order."""
    tiles = -(-time_steps // ROWS)
    return [((tiles - 1 - i // batch_heads) * ROWS, i % batch_heads)
            for i in range(tiles * batch_heads)]


def block_tiles(q0, length, causal, window):
    """The block's first key and tile count and each warpgroup's tile range
    [first, end), as the kernel computes them; None when no row of the
    block sees a key (q0 >= len)."""
    if q0 >= length:
        return None
    kv_end = min(length, q0 + ROWS) if causal else length
    kv_first = (max(0, q0 - window + 1) // KEYS) * KEYS if window else 0
    ranges = []
    for group in range(ROWS // GROUP):
        r_lo = q0 + GROUP * group
        if r_lo >= length:
            ranges.append((0, 0))
            continue
        key_end = min(length, r_lo + GROUP) if causal else length
        key_first = max(0, r_lo - window + 1) if window else 0
        ranges.append(((key_first - kv_first) // KEYS, -(-(key_end - kv_first) // KEYS)))
    return kv_first, -(-(kv_end - kv_first) // KEYS), ranges


def _visible(rows, keys, length, causal, window):
    i, j = rows[:, None], keys[None, :]
    seen = (i < length) & (j < length)
    if causal:
        seen &= j <= i
    if window:
        seen &= i - j < window
    return seen


def _values(pb, v):
    """pb . v in f32, each output column a running sum over the keys in
    order (the last step of a cumulative sum), the same bits whatever the
    number of columns."""
    return torch.cumsum(pb[..., :, :, None] * v[..., None, :, :], dim=-2)[..., -1, :]


def emulated_k5b(q, k, v, seq_len=None, causal=False, window=None, pad=True):
    """csrc/attn_fwd_bf16.cu's order of operations on bf16 q, k, v (B, H, T,
    dh): ``(o, lse)`` in f32. With ``pad`` the tiles are whole 64-column
    slabs (dh 96 read with 32 zero columns, as the TMA fills them)."""
    batch, heads, time_steps, head_dim = q.shape
    cols = 64 * -(-head_dim // 64) if pad else head_dim
    qf, kf, vf = (torch.nn.functional.pad(t.float(), (0, cols - head_dim)) for t in (q, k, v))
    scale_log2 = np.float32(LOG2E) / np.float32(math.sqrt(head_dim))
    o = torch.zeros((batch, heads, time_steps, head_dim))
    lse = torch.full((batch, heads, time_steps), torch.inf)
    window = window or 0
    for b in range(batch):
        length = time_steps if seq_len is None else min(max(int(seq_len[b]), 0), time_steps)
        for q0 in range(0, time_steps, ROWS):
            plan = block_tiles(q0, length, causal, window)
            if plan is None:
                continue
            kv_first, _, ranges = plan
            for group, (first, end) in enumerate(ranges):
                if q0 + GROUP * group >= time_steps or first == end:
                    continue
                rows = torch.arange(q0 + GROUP * group, min(q0 + GROUP * (group + 1), time_steps))
                m = torch.full((heads, len(rows)), -torch.inf)
                l = torch.zeros((heads, len(rows)))
                acc = torch.zeros((heads, len(rows), cols))
                for j in range(first, end):
                    keys = torch.arange(kv_first + j * KEYS, kv_first + (j + 1) * KEYS)
                    keys = keys[keys < time_steps]   # rows past T read as zeros, all masked
                    s = 0.0
                    for c in range(0, head_dim, K_STEP):
                        s = s + torch.matmul(qf[b][:, rows, c:c + K_STEP],
                                             kf[b][:, keys, c:c + K_STEP].transpose(-1, -2))
                    s = torch.where(_visible(rows, keys, length, causal, window), s, -torch.inf)
                    m_new = torch.maximum(m, s.amax(-1) * scale_log2)
                    m_use = torch.where(m_new == -torch.inf, 0.0, m_new)
                    alpha = torch.exp2(m - m_use)
                    m, l = m_new, l * alpha
                    # s * scale_log2 - m in one rounding, the kernel's fused multiply-add
                    p = torch.exp2((s.double() * float(scale_log2)
                                    - m_use.double()[..., None]).float())
                    l = l + p.sum(-1)
                    acc = acc * alpha[..., None] + _values(round_bf16(p), vf[b][:, keys])
                inv = torch.where(l > 0, 1.0 / l, 0.0)
                o[b][:, rows] = (acc * inv[..., None])[..., :head_dim]
                lse[b][:, rows] = torch.where(l > 0, (m + torch.log2(l)) * LN2, torch.inf)
    return o, lse


MASKS = {'full': (False, None, False), 'causal': (True, None, False),
         'window8': (True, 8, False), 'window16': (True, 16, False),
         'ragged': (False, None, True)}


def _case(steps, head_dim, mask):
    causal, window, ragged = MASKS[mask]
    rng = np.random.default_rng(150 + steps + head_dim + len(mask))
    q, k, v = (rng.normal(size=(2, 2, steps, head_dim)).astype(np.float32) for _ in range(3))
    seq_len = np.array([max(1, steps - steps // 3), 0]) if ragged else None
    return q, k, v, seq_len, causal, window


@pytest.mark.parametrize('mask', list(MASKS))
@pytest.mark.parametrize('head_dim', fa.HEAD_DIMS)
@pytest.mark.parametrize('steps', [1, 77, 200])
def test_emulated_k5b_matches_plain_version_and_jax(steps, head_dim, mask):
    """K5b emulated at B2 H2 against the plain bf16 attention on the same
    bf16 q, k, v (within BF16_ULPS ulps of the largest |value| on the rows
    below seq_len, nearer in the mean than the f32 plain version, within
    K5B_O_OF_CONTROL times the control's largest |error|) and
    against JAX's exact bf16 attention: within MAX_RTOL of the largest
    |value|, and in the mean no farther from it than it is from the f32
    attention (tests/test_torch_bf16.py's mean bound, 3e-5 of the largest
    |value|, is for paths that round where JAX does: rounding the
    unnormalised probabilities instead puts K5b 1.5-3.4e-4 from JAX in the
    mean, as far as JAX's own rounding puts it from f32);
    the zero columns of dh 96 change no bit; a row that sees no key is 0
    with lse +inf, and lse is the plain logits' log-sum-exp."""
    q, k, v, seq_len, causal, window = _case(steps, head_dim, mask)
    qb, kb, vb = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    sl = None if seq_len is None else torch.from_numpy(seq_len)
    mask_kw = dict(seq_len=sl, causal=causal, window=window)
    got, lse = emulated_k5b(qb, kb, vb, **mask_kw)
    if head_dim % 64:   # dh 96: its zero columns 96-127 change no bit
        bare, bare_lse = emulated_k5b(qb, kb, vb, pad=False, **mask_kw)
        assert torch.equal(got, bare) and torch.equal(lse, bare_lse)

    rows = np.arange(steps)[None, :] < (np.full(2, steps) if seq_len is None else seq_len)[:, None]
    valid = torch.from_numpy(rows)[:, None, :, None]
    want = fa.flash_attention_reference(qb.float(), kb.float(), vb.float(),
                                        compute_dtype=torch.bfloat16, **mask_kw) * valid
    f32 = fa.flash_attention_reference(*(torch.from_numpy(a) for a in (q, k, v)),
                                       **mask_kw) * valid
    top = float(want.abs().max())
    err = (got * valid - want).abs()
    assert float(err.max()) <= BF16_ULPS * 2.0 ** -7 * top, float(err.max()) / top
    near, far = float(err.mean()), float((got * valid - f32).abs().mean())
    assert near * K5B_CLOSER <= far and (near < far or far == 0), (near, far)
    control = fa.flash_attention_reference(qb.float(), kb.float(), vb.float(), **mask_kw) * valid
    assert float(err.max()) <= (K5B_O_OF_CONTROL * float((control - want).abs().max())
                                + F32_SLACK * top)

    bias = fa.attention_bias(sl, steps, causal, window)
    jax_o = np.asarray(jattention.scaled_dot_product_attention(
        q, k, v, bias=None if bias is None else jnp.asarray(bias.numpy()),
        compute_dtype=jnp.bfloat16), np.float64) * rows[:, None, :, None]
    jerr = np.abs((got * valid).numpy().astype(np.float64) - jax_o)
    assert jerr.max() <= MAX_RTOL * np.abs(jax_o).max(), jerr.max() / np.abs(jax_o).max()
    rounding = np.abs(jax_o - f32.numpy()).mean()
    assert jerr.mean() <= rounding, (jerr.mean(), rounding)

    logits = torch.matmul(qb.float(), kb.float().transpose(-1, -2)) / math.sqrt(head_dim)
    want_lse = torch.logsumexp(logits if bias is None else logits + bias, -1)
    lse_rows = valid[..., 0]
    torch.testing.assert_close(torch.where(lse_rows, lse, 0.0), torch.where(lse_rows, want_lse, 0.0),
                               rtol=0, atol=1e-5 * max(1.0, float(want_lse.abs().max())))
    if seq_len is not None:
        assert (got[-1] == 0).all() and torch.isinf(lse[-1]).all()


@pytest.mark.parametrize('mask', list(MASKS))
@pytest.mark.parametrize('steps', [1, 63, 64, 65, 130, 300, 1024])
def test_tile_ranges_visit_each_visible_pair_once(steps, mask):
    """The 1-D grid gives each (query tile, b * h) one block, the last
    query tile first; the tiles each warpgroup computes cover every
    (query, key) pair its rows see, none twice, and lie in the block's
    loaded tiles; a block with no visible pair loads nothing (windows of
    8, 16 and, at T1024, 256)."""
    causal, window, ragged = MASKS[mask]
    if steps == 1024 and window:
        window = 256
    order = grid_order(steps, 3)
    tiles = -(-steps // ROWS)
    assert sorted(order) == sorted((q0, bh) for q0 in range(0, tiles * ROWS, ROWS)
                                   for bh in range(3))
    assert [q0 for q0, _ in order[:3]] == [(tiles - 1) * ROWS] * 3
    lengths = [steps, max(1, steps // 3), 0] if ragged else [steps]
    for length in lengths:
        for q0, _ in order[::3]:
            plan = block_tiles(q0, length, causal, window or 0)
            rows = np.arange(q0, min(q0 + ROWS, steps))
            seen = _visible(torch.from_numpy(rows), torch.arange(steps), length, causal,
                            window or 0).numpy()
            if plan is None:
                assert not seen.any()
                continue
            kv_first, n_kv, ranges = plan
            assert n_kv >= 1
            for group, (first, end) in enumerate(ranges):
                assert 0 <= first <= end <= n_kv
                part = (rows >= q0 + GROUP * group) & (rows < q0 + GROUP * (group + 1))
                visits = np.zeros((part.sum(), steps), np.int64)
                for j in range(first, end):
                    k0 = kv_first + j * KEYS
                    visits[:, k0:k0 + KEYS] += 1
                assert (visits <= 1).all()
                assert (visits[seen[part]] == 1).all()
                if first < end:   # the first and last tiles each hold a visible pair
                    for j in (first, end - 1):
                        k0 = kv_first + j * KEYS
                        assert seen[part][:, k0:k0 + KEYS].any()

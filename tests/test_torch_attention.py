"""The port's attention (``ops/attention.py``, ``ops/flash_attention.py``) and
Transformer modules (``LayerNorm``, ``GELU``, ``MultiHeadAttention``,
``TransformerEncoderLayer``, ``TransformerEncoder``) against the JAX package
on the CPU, with inputs and weights from seeded numpy.

On the CPU the port runs the kernel's plain version. It is held to 1e-5 abs
(gradients to 1e-5 of each gradient's max |value|), f32 on both sides, on
valid rows only: padded query rows are undefined in the JAX package
(``nn.py:1007-1012``), so the outputs are compared at rows below
``seq_len`` and the losses read those rows alone. The references are the
JAX 'xla' path and, for ``MultiHeadAttention``, the splash kernel itself in
interpret mode, driven through the JAX package's own ``_splash`` (padding to
its block layout, pre-scaled q, segment ids, vmap). The kernel K5/K6 is held
against the plain version on the GPU by ``tests/test_torch_kernels.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morgana_tpu import nn as jnn
from morgana_tpu.ops import attention as jattention

from morgana_tpu_torch import nn as tnn
from morgana_tpu_torch.ops import attention as tattention
from morgana_tpu_torch.ops import flash_attention as fa

ATOL = 1e-5
GRAD_RTOL = 1e-5
MASKS = [(False, None), (True, None), (True, 5)]
MASK_IDS = ['full', 'causal', 'window5']


def _t(array):
    return torch.from_numpy(np.asarray(array))


def _valid(seq_len, time):
    """(B, T, 1) float mask of the rows below seq_len."""
    return (np.arange(time)[None, :] < np.asarray(seq_len)[:, None]).astype(np.float32)[..., None]


def test_biases_match_jax():
    """Padding, causal, sliding-window and streaming biases: exact."""
    seq_len = np.array([7, 0, 3], np.int32)
    pairs = [
        (jattention.padding_bias(jnp.asarray(seq_len), 9), tattention.padding_bias(_t(seq_len), 9)),
        (jattention.padding_bias(jnp.asarray(seq_len[:, None]), 9),
         tattention.padding_bias(_t(seq_len[:, None]), 9)),
        (jattention.causal_bias(6), tattention.causal_bias(6)),
        (jattention.local_causal_bias(9, 3), tattention.local_causal_bias(9, 3)),
        (jattention.streaming_bias(2, 4, 3), tattention.streaming_bias(2, 4, 3)),
        (jattention.streaming_bias(10, 4, 3), tattention.streaming_bias(10, 4, 3)),
    ]
    for want, got in pairs:
        assert tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize('max_len,dim', [(17, 8), (1100, 384)])
def test_sinusoidal_positions_match_jax(max_len, dim):
    """The interleaved (sin, cos) table, up to the longest bucket at the
    model's width: 1e-5 abs (f32 angles of up to ~1100 radians)."""
    np.testing.assert_allclose(tattention.sinusoidal_positions(max_len, dim).numpy(),
                               np.asarray(jattention.sinusoidal_positions(max_len, dim)), atol=ATOL)
    positions = np.array([0, 5, 300], np.float32)
    np.testing.assert_allclose(tattention.sinusoidal_positions_at(_t(positions), dim).numpy(),
                               np.asarray(jattention.sinusoidal_positions_at(positions, dim)),
                               atol=ATOL)
    with pytest.raises(ValueError, match='even'):
        tattention.sinusoidal_positions(4, 7)


def _qkv(seed, batch=3, heads=2, time=11, head_dim=8):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(batch, heads, time, head_dim)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize('causal,window', MASKS, ids=MASK_IDS)
def test_plain_attention_and_gradients_match_jax(causal, window):
    """flash_attention on CPU tensors (its plain version) against
    scaled_dot_product_attention with the JAX biases: outputs on valid rows
    within 1e-5 abs, and the gradients of a loss on valid rows within 1e-5
    of each gradient's max."""
    q, k, v = _qkv(0)
    seq_len = np.array([11, 6, 1], np.int32)
    time = q.shape[2]
    weight = np.random.default_rng(1).normal(size=q.shape).astype(np.float32)
    weight *= _valid(seq_len, time)[:, None]

    def jax_loss(q, k, v):
        bias = jattention.padding_bias(jnp.asarray(seq_len), time)
        if causal:
            bias = bias + (jattention.local_causal_bias(time, window) if window
                           else jattention.causal_bias(time))
        out = jattention.scaled_dot_product_attention(q, k, v, bias=bias)
        return jnp.sum(out * weight), out

    (_, want), want_grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(
        *map(jnp.asarray, (q, k, v)))
    leaves = [_t(a).requires_grad_(True) for a in (q, k, v)]
    got = fa.flash_attention(*leaves, seq_len=_t(seq_len), causal=causal, window=window)
    got_grads = torch.autograd.grad((got * _t(weight)).sum(), leaves)
    mask = _valid(seq_len, time)[:, None]
    np.testing.assert_allclose(got.detach().numpy() * mask, np.asarray(want) * mask, atol=ATOL)
    for g, w in zip(got_grads, want_grads):
        scale = float(np.abs(np.asarray(w)).max())
        np.testing.assert_allclose(g.numpy() / scale, np.asarray(w) / scale, atol=GRAD_RTOL)


def test_window_needs_causal():
    q, k, v = map(_t, _qkv(2))
    with pytest.raises(ValueError, match='causal'):
        fa.flash_attention(q, k, v, window=4)
    with pytest.raises(ValueError, match='causal'):
        tnn.MultiHeadAttention(16, 2)(torch.zeros(1, 3, 16), window=2)


def test_layer_norm_and_gelu_match_jax():
    """eps 1e-5, the population variance and the erf GELU: 1e-5 abs (on
    inputs with a large mean, where a sample variance would differ)."""
    rng = np.random.default_rng(3)
    x = (5.0 + 3.0 * rng.normal(size=(2, 7, 24))).astype(np.float32)
    jln = jnn.LayerNorm(24)
    tln = tnn.LayerNorm(24)
    params = {'weight': rng.normal(size=24).astype(np.float32),
              'bias': rng.normal(size=24).astype(np.float32)}
    jnn.load_state_dict(jln, params)
    tnn.load_jax_params(tln, params)
    with torch.no_grad():
        np.testing.assert_allclose(tln(_t(x)).numpy(), np.asarray(jln(jnp.asarray(x))), atol=ATOL)
    np.testing.assert_allclose(tnn.GELU()(_t(x - 5.0)).numpy(),
                               np.asarray(jnn.GELU()(jnp.asarray(x - 5.0))), atol=ATOL)


def _copy_params(jmodule, tmodule, seed):
    """Seeded numpy weights into both modules, by the JAX names."""
    rng = np.random.default_rng(seed)
    params = {name: (0.2 * rng.normal(size=np.shape(value))).astype(np.float32)
              for name, value in jnn.state_dict(jmodule).items()}
    params.update({name: (1.0 + 0.1 * rng.normal(size=value.shape)).astype(np.float32)
                   for name, value in params.items() if name.endswith('norm.weight')})
    jnn.load_state_dict(jmodule, params)
    tnn.load_jax_params(tmodule, params)
    return params


def _compare(jmodule, tmodule, params, x, seq_len, call, seed):
    """Outputs on valid rows, and the gradients (x and every parameter) of a
    loss that reads valid rows only: 1e-5 abs and 1e-5 of each max."""
    time = x.shape[1]
    weight = np.random.default_rng(seed).normal(size=x.shape).astype(np.float32)
    weight *= _valid(seq_len, time)

    def jax_loss(p, x):
        with jnn.bind(jmodule, p):
            out = call(jmodule, x, jnp.asarray(seq_len))
        return jnp.sum(out * weight), out

    (_, want), (want_p, want_x) = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    x_t = _t(x).requires_grad_(True)
    got = call(tmodule, x_t, _t(seq_len))
    named = dict(tmodule.named_parameters())
    grads = torch.autograd.grad((got * _t(weight)).sum(), [x_t] + list(named.values()))
    mask = _valid(seq_len, time)
    np.testing.assert_allclose(got.detach().numpy() * mask, np.asarray(want) * mask, atol=ATOL)
    wants = [want_x] + [want_p[name] for name in named]
    for name, g, w in zip(['x'] + list(named), grads, wants):
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g.numpy() / scale, w / scale, atol=GRAD_RTOL, err_msg=name)


@pytest.mark.parametrize('causal,window', MASKS, ids=MASK_IDS)
def test_multi_head_attention_matches_jax_xla(causal, window):
    """MultiHeadAttention (fused in_proj, 4 heads of 8, out_proj) against the
    JAX module's 'xla' path, ragged seq_len with a row of length 1."""
    jnn.manual_seed(4)
    jmha, tmha = jnn.MultiHeadAttention(32, 4, backend='xla'), tnn.MultiHeadAttention(32, 4)
    params = _copy_params(jmha, tmha, 5)
    x = np.random.default_rng(6).normal(size=(3, 13, 32)).astype(np.float32)
    _compare(jmha, tmha, params, x, np.array([13, 9, 1], np.int32),
             lambda m, x, sl: m(x, seq_len=sl, causal=causal, window=window), 7)


def _splash_interpret(jmha):
    """The JAX instance's splash kernel built as nn.py:963-977 builds it, in
    interpret mode, so that the TPU kernel runs on the CPU."""
    from jax.experimental.pallas.ops.tpu.splash_attention import (
        splash_attention_kernel as sk, splash_attention_mask as sm)

    def kernel(q_len, block, causal, window):
        if window is not None:
            head_mask = sm.LocalMask((q_len, q_len), window_size=(window - 1, 0), offset=0)
        elif causal:
            head_mask = sm.CausalMask((q_len, q_len))
        else:
            head_mask = sm.FullMask((q_len, q_len))
        block_sizes = sk.BlockSizes(block_q=block, block_kv=block, block_kv_compute=block,
                                    block_q_dkv=block, block_kv_dkv=block,
                                    block_kv_dkv_compute=block, use_fused_bwd_kernel=True)
        return sk.make_splash_mha(sm.MultiHeadMask([head_mask] * jmha.num_heads), head_shards=1,
                                  q_seq_shards=1, block_sizes=block_sizes, interpret=True)
    return kernel


@pytest.mark.parametrize('time', [256, 320])
@pytest.mark.parametrize('causal,window', [(False, None), (True, None), (True, 64)],
                         ids=['full', 'causal', 'window64'])
def test_multi_head_attention_matches_splash_in_interpret_mode(monkeypatch, time, causal, window):
    """The JAX module with _on_tpu patched to True runs its own _splash, with
    the splash kernel in interpret mode (320 pads to the 384 block layout):
    the port's MultiHeadAttention matches its forward and jax.grad, 2 heads
    of 64, ragged seq_len."""
    monkeypatch.setattr(jnn, '_on_tpu', lambda: True)
    jnn.manual_seed(8)
    jmha, tmha = jnn.MultiHeadAttention(128, 2, backend='splash'), tnn.MultiHeadAttention(128, 2)
    monkeypatch.setattr(jmha, '_splash_kernel', _splash_interpret(jmha))
    called = []
    splash = jmha._splash
    monkeypatch.setattr(jmha, '_splash', lambda *a, **k: called.append(1) or splash(*a, **k))
    params = _copy_params(jmha, tmha, 9)
    x = np.random.default_rng(10).normal(size=(2, time, 128)).astype(np.float32)
    _compare(jmha, tmha, params, x, np.array([time, int(0.66 * time)], np.int32),
             lambda m, x, sl: m(x, seq_len=sl, causal=causal, window=window), 11)
    assert called, 'the JAX module did not take its splash path'


@pytest.mark.parametrize('causal,window', MASKS, ids=MASK_IDS)
def test_encoder_layer_and_encoder_match_jax(causal, window):
    """A pre-LN block, and a 2-block encoder with positions and the final
    norm, against the JAX modules (d_model 32, 4 heads, d_ff 64)."""
    x = np.random.default_rng(12).normal(size=(3, 13, 32)).astype(np.float32)
    seq_len = np.array([13, 7, 1], np.int32)
    jnn.manual_seed(13)
    jlayer, tlayer = jnn.TransformerEncoderLayer(32, 4, 64), tnn.TransformerEncoderLayer(32, 4, 64)
    _compare(jlayer, tlayer, _copy_params(jlayer, tlayer, 14), x, seq_len,
             lambda m, x, sl: m(x, seq_len=sl, causal=causal, window=window), 15)
    jnn.manual_seed(16)
    jenc = jnn.TransformerEncoder(2, 32, 4, 64, causal=causal, window=window)
    tenc = tnn.TransformerEncoder(2, 32, 4, 64, causal=causal, window=window)
    assert sorted(jnn.state_dict(jenc)) == sorted(tnn.state_dict(tenc))
    _compare(jenc, tenc, _copy_params(jenc, tenc, 17), x, seq_len,
             lambda m, x, sl: m(x, seq_len=sl), 18)


def test_sequential_threads_seq_len_into_attention_members():
    """SequentialWithRecurrent gives seq_len to members that set
    accepts_seq_len: the container's output equals the encoder called with
    the lengths, and differs from it without them."""
    torch.manual_seed(19)
    encoder = tnn.TransformerEncoder(1, 16, 2, 32)
    linear = tnn.Linear(5, 16)
    seq = tnn.SequentialWithRecurrent(linear, encoder)
    x = torch.randn(2, 9, 5)
    seq_len = torch.tensor([9, 4])
    with torch.no_grad():
        got = seq(x, seq_len=seq_len)
        want = encoder(linear(x), seq_len=seq_len)
        unmasked = encoder(linear(x))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not torch.allclose(got[1, :4], unmasked[1, :4])


def test_probability_dropout_on_the_cpu():
    """In training, probability dropout draws from the module's generator
    (the trainer sets it each step): the same generator seed gives the same
    output, another seed another one; in eval it is off."""
    torch.manual_seed(20)
    mha = tnn.MultiHeadAttention(16, 2, dropout=0.5)
    x = torch.randn(2, 6, 16)
    outs = []
    for seed in (1, 1, 2):
        mha.generator = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            outs.append(mha(x))
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    assert not torch.allclose(outs[0], outs[2])
    no_dropout = tnn.MultiHeadAttention(16, 2)
    no_dropout.load_state_dict(mha.state_dict())
    mha.eval()
    with torch.no_grad():
        torch.testing.assert_close(mha(x), no_dropout(x), rtol=0, atol=0)


@pytest.mark.parametrize('backend', ['auto', 'xla', 'splash', 'flash'])
def test_every_backend_computes_the_same_function(backend):
    """The JAX backend names all run the same attention (the kernel on the
    GPU, the plain version here); an unknown name is refused."""
    torch.manual_seed(21)
    ref = tnn.MultiHeadAttention(16, 2)
    mha = tnn.MultiHeadAttention(16, 2, backend=backend)
    mha.load_state_dict(ref.state_dict())
    x = torch.randn(2, 5, 16)
    with torch.no_grad():
        torch.testing.assert_close(mha(x, seq_len=torch.tensor([5, 3])),
                                   ref(x, seq_len=torch.tensor([5, 3])), rtol=0, atol=0)
    with pytest.raises(ValueError, match='backend'):
        tnn.MultiHeadAttention(16, 2, backend='cudnn')


def _tf32_nearest(x):
    """x rounded to TF32 (round to nearest, ties away from zero, on the 13 low
    mantissa bits), as cvt.rna.tf32.f32 does."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32_truncated(x):
    """x as the tensor core reads an f32 register in TF32: its 13 low
    mantissa bits ignored."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def _split_matmul(a, b, terms, split):
    """a @ b as the tensor cores compute it in TF32 with f32 sums: one term
    (each operand rounded), or three (hi = split(x), lo = x - hi; lo.hi +
    hi.lo + hi.hi, every operand read through the tensor core's truncation)."""
    if terms == 1:
        return _tf32_nearest(a) @ _tf32_nearest(b)
    a_hi, b_hi = split(a), split(b)
    a_lo, b_lo = _tf32_truncated(a - a_hi), _tf32_truncated(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


@pytest.mark.parametrize('terms,split,within', [
    (3, _tf32_nearest, True), (3, _tf32_truncated, True), (1, None, False)],
    ids=['3xtf32_nearest', '3xtf32_truncated_as_the_kernels', '1xtf32'])
def test_why_the_kernels_run_3xtf32(terms, split, within):
    """The tolerance argument of K5/K6's design, without a card: attention
    whose two products run in TF32 on emulated tensor cores, at B2 H4 T256
    dh96 with ragged seq_len and seeded N(0, 1) inputs, against the f32
    plain version on valid rows. With each operand split into a TF32 high
    part and a low part and three products summed (hi by round to nearest,
    or truncated as the kernels split it), it stays within the card checks'
    1e-4 abs; with one TF32 product it does not."""
    q, k, v = (_t(a) for a in _qkv(40, batch=2, heads=4, time=256, head_dim=96))
    seq_len = torch.tensor([256, 141])
    bias = fa.attention_bias(seq_len, 256)
    with torch.no_grad():
        logits = _split_matmul(q, k.transpose(-1, -2), terms, split) / np.sqrt(96.0) + bias
        got = _split_matmul(torch.softmax(logits, dim=-1), v, terms, split)
        want = fa.flash_attention_reference(q, k, v, seq_len=seq_len)
    valid = _t(_valid(seq_len.numpy(), 256))[:, None]
    err = float(((got - want) * valid).abs().max())
    assert (err <= 1e-4) == within, err

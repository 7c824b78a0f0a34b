"""The port's kernels as ``torch.library`` custom ops of the ``morgana``
namespace, on the CPU, where each runs its plain version.

Each op against the plain function its wrapper called before it was an op:
equal, bit for bit (the same code on the same inputs), at small seeded
shapes with ragged ``seq_len`` and empty sequences (whose outputs must be
tensors of the op's own, not its inputs). ``torch.library.opcheck`` holds
each schema and fake (shape) implementation to the real one, and
``torch.export`` of each op's caller under ``no_grad`` (serving) holds one
``morgana::`` node per call. The kernels themselves run on the card only
(``tests/test_torch_kernels.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

from morgana_tpu_torch.ops import flash_attention as fa
from morgana_tpu_torch.ops import gru as gru_ops
from morgana_tpu_torch.ops import lstm as lstm_ops
from morgana_tpu_torch.ops import weight_grad

B, T, H = 3, 9, 8


def _arr(rng, *shape, scale=1.0):
    return torch.from_numpy((scale * rng.normal(size=shape)).astype(np.float32))


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def _opcheck(op, args):
    torch.library.opcheck(op, args, test_utils=('test_schema', 'test_faketensor'))


def _fresh(outputs, inputs):
    """No output that holds memory shares it with an input or another output."""
    ptrs = [t.untyped_storage().data_ptr() for t in list(inputs) + list(outputs)
            if isinstance(t, torch.Tensor) and t.numel()]
    return len(ptrs) == len(set(ptrs))


@pytest.mark.parametrize('time', [T, 0])
@pytest.mark.parametrize('with_gates', [False, True])
def test_lstm_ops_are_their_plain_versions(time, with_gates):
    rng = np.random.default_rng(1)
    xg, w_hh, h0, c0 = _arr(rng, time, B, 4 * H), _arr(rng, H, 4 * H, scale=0.3), \
        _arr(rng, B, H), _arr(rng, B, H)
    got = torch.ops.morgana.lstm_fwd(xg, w_hh, h0, c0, with_gates)
    y, c_all, g_all, hn, cn = lstm_ops.lstm_recurrence_reference(xg, w_hh, h0, c0)
    _equal(got, (y, c_all, g_all if with_gates else torch.empty(0), hn, cn))
    assert _fresh(got, (xg, w_hh, h0, c0))
    _opcheck(torch.ops.morgana.lstm_fwd.default, (xg, w_hh, h0, c0, with_gates))

    dy, dc_all = _arr(rng, time, B, H), _arr(rng, time, B, H)
    dhn, dcn = _arr(rng, B, H), _arr(rng, B, H)
    args = (g_all, w_hh, c0, c_all, dy, dc_all, dhn, dcn)
    got = torch.ops.morgana.lstm_bwd(*args)
    _equal(got, lstm_ops.lstm_backward_reference(*args))
    assert _fresh(got, args)
    _opcheck(torch.ops.morgana.lstm_bwd.default, args)


@pytest.mark.parametrize('time', [T, 0])
@pytest.mark.parametrize('ragged', [False, True], ids=['no_seq_len', 'ragged'])
def test_gru_ops_are_their_plain_versions(time, ragged):
    rng = np.random.default_rng(2)
    xg, w_hh, b_hh, h0 = _arr(rng, B, time, 3 * H), _arr(rng, H, 3 * H, scale=0.3), \
        _arr(rng, 3 * H), _arr(rng, B, H)
    seq_len = torch.tensor([time, time // 2, 0]) if ragged else None
    got = torch.ops.morgana.gru_fwd(xg, w_hh, b_hh, h0, seq_len)
    y, hn = gru_ops.gru_recurrence_reference(xg.transpose(0, 1), w_hh, b_hh, h0)
    y, hn = gru_ops._mask(y.transpose(0, 1), hn, seq_len, h0)
    _equal(got, (y, hn))
    assert _fresh(got, (xg, w_hh, b_hh, h0))
    _opcheck(torch.ops.morgana.gru_fwd.default, (xg, w_hh, b_hh, h0, seq_len))

    _, hg = gru_ops.hidden_gates(w_hh, b_hh, h0, got[0], batch_first=True)
    dy, dhn = _arr(rng, B, time, H), _arr(rng, B, H)
    args = (xg, hg, w_hh, h0, got[0], dy, dhn, seq_len)
    out = torch.ops.morgana.gru_bwd(*args)
    _equal(out, gru_ops.layer_backward_reference(*args))
    assert _fresh(out, args)
    _opcheck(torch.ops.morgana.gru_bwd.default, args)


@pytest.mark.parametrize('causal,window', [(False, 0), (True, 0), (True, 4)],
                         ids=['full', 'causal', 'window'])
def test_attention_ops_are_their_plain_versions(causal, window):
    """The forward's o is the plain version's and lse the log-sum-exp of its
    biased logits; the backward is autograd's through the plain version."""
    rng = np.random.default_rng(3)
    q, k, v, do = (_arr(rng, 2, 2, T, 16) for _ in range(4))
    seq_len = torch.tensor([T, 4], dtype=torch.int32)
    o, lse = torch.ops.morgana.attn_fwd(q, k, v, seq_len, causal, window)
    torch.testing.assert_close(o, fa.flash_attention_reference(q, k, v, seq_len, causal,
                                                               window or None), rtol=0, atol=0)
    bias = fa.attention_bias(seq_len, T, causal, window or None)
    logits = q @ k.transpose(-1, -2) / 4.0 + bias
    torch.testing.assert_close(lse, torch.logsumexp(logits, -1), rtol=1e-6, atol=1e-6)
    _opcheck(torch.ops.morgana.attn_fwd.default, (q, k, v, seq_len, causal, window))

    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(fa.flash_attention_reference(*leaves, seq_len, causal,
                                                            window or None), leaves, do)
    args = (q, k, v, o, lse, do, seq_len, causal, window)
    got = torch.ops.morgana.attn_bwd(*args)
    _equal(got, want)
    assert _fresh(got, args)
    _opcheck(torch.ops.morgana.attn_bwd.default, args)


@pytest.mark.parametrize('op', ['lstm', 'gru', 'attention'])
def test_bf16_compute_ops_are_their_plain_versions(op):
    """The ops' bf16-compute forms (K1c and K3c: ``compute_bf16``; K5b: bf16
    q, k and v): equal to the plain versions with bf16 products, bit for
    bit, and other than the f32 forms; opcheck holds the changed schemas and
    fakes (f32 outputs of every form)."""
    rng = np.random.default_rng(6)
    if op == 'lstm':
        args = (_arr(rng, T, B, 4 * H), _arr(rng, H, 4 * H, scale=0.3), _arr(rng, B, H),
                _arr(rng, B, H), False)
        got = torch.ops.morgana.lstm_fwd(*args, True)
        want = lstm_ops.lstm_recurrence_reference(*args[:4], compute_bf16=True)
        want = want[:2] + (torch.empty(0),) + want[3:]
        f32 = torch.ops.morgana.lstm_fwd(*args)
        target, args = torch.ops.morgana.lstm_fwd.default, args + (True,)
    elif op == 'gru':
        args = (_arr(rng, B, T, 3 * H), _arr(rng, H, 3 * H, scale=0.3), _arr(rng, 3 * H),
                _arr(rng, B, H), torch.tensor([T, 4, 0]))
        got = torch.ops.morgana.gru_fwd(*args, True)
        want = gru_ops._plain_layer_forward(*args, True)
        f32 = torch.ops.morgana.gru_fwd(*args)
        target, args = torch.ops.morgana.gru_fwd.default, args + (True,)
    else:
        q, k, v = (_arr(rng, 2, 2, T, 16) for _ in range(3))
        seq_len = torch.tensor([T, 4], dtype=torch.int32)
        args = (q.bfloat16(), k.bfloat16(), v.bfloat16(), seq_len, True, 0)
        got = torch.ops.morgana.attn_fwd(*args)
        o = fa.flash_attention_reference(q, k, v, seq_len, True, None,
                                         compute_dtype=torch.bfloat16)
        bias = fa.attention_bias(seq_len, T, True, None)
        logits = args[0].float() @ args[1].float().transpose(-1, -2) / 4.0 + bias
        want = (o, torch.logsumexp(logits, -1))
        f32 = torch.ops.morgana.attn_fwd(q, k, v, seq_len, True, 0)
        target = torch.ops.morgana.attn_fwd.default
    assert all(t.dtype == torch.float32 for t in got)
    _equal(got, want)
    assert not torch.equal(got[0], f32[0])
    _opcheck(target, args)


@pytest.mark.parametrize('op', ['lstm', 'gru', 'attention', 'carry'])
def test_bf16_backward_ops_are_their_plain_versions(op):
    """The backward ops' bf16 forms (K2c and K4c: ``compute_bf16``; K5b's
    backward: bf16 q, k and v; the bf16 carry ``morgana::rnn_dw_bf16``):
    equal to their plain versions bit for bit, other than the f32 forms
    (the carry: than the f32 sum rounded once), with fresh outputs;
    opcheck holds the schemas and fakes."""
    rng = np.random.default_rng(7)
    if op == 'lstm':
        xg, w_hh, h0, c0 = _arr(rng, T, B, 4 * H), _arr(rng, H, 4 * H, scale=0.3), \
            _arr(rng, B, H), _arr(rng, B, H)
        _, c_all, g_all, _, _ = lstm_ops.lstm_recurrence_reference(xg, w_hh, h0, c0, True)
        args = (g_all, w_hh, c0, c_all, _arr(rng, T, B, H), _arr(rng, T, B, H),
                _arr(rng, B, H), _arr(rng, B, H))
        got = torch.ops.morgana.lstm_bwd(*args, True)
        want = lstm_ops.lstm_backward_reference(*args, compute_bf16=True)
        f32 = torch.ops.morgana.lstm_bwd(*args)
        target, args = torch.ops.morgana.lstm_bwd.default, args + (True,)
    elif op == 'gru':
        xg, w_hh, b_hh, h0 = _arr(rng, B, T, 3 * H), _arr(rng, H, 3 * H, scale=0.3), \
            _arr(rng, 3 * H), _arr(rng, B, H)
        seq_len = torch.tensor([T, 4, 0])
        y, _ = gru_ops._plain_layer_forward(xg, w_hh, b_hh, h0, seq_len, True)
        _, hg = gru_ops.hidden_gates(w_hh, b_hh, h0, y, batch_first=True,
                                     compute=torch.bfloat16)
        args = (xg, hg, w_hh, h0, y, _arr(rng, B, T, H), _arr(rng, B, H), seq_len)
        got = torch.ops.morgana.gru_bwd(*args, True)
        want = gru_ops.layer_backward_reference(*args, compute_bf16=True)
        f32 = torch.ops.morgana.gru_bwd(*args)
        target, args = torch.ops.morgana.gru_bwd.default, args + (True,)
    elif op == 'attention':
        q, k, v, do = (_arr(rng, 2, 2, T, 16) for _ in range(4))
        seq_len = torch.tensor([T, 4], dtype=torch.int32)
        o, lse = torch.ops.morgana.attn_fwd(q, k, v, seq_len, True, 4)
        args = (q.bfloat16(), k.bfloat16(), v.bfloat16(), o, lse, do, seq_len, True, 4)
        got = torch.ops.morgana.attn_bwd(*args)
        want = fa.attention_backward_reference(*args[:3], do, seq_len, True, 4)
        f32 = torch.ops.morgana.attn_bwd(q, k, v, o, lse, do, seq_len, True, 4)
        target = torch.ops.morgana.attn_bwd.default
        assert all(t.dtype == torch.bfloat16 for t in got)
    else:
        args = (_arr(rng, T, B, H), _arr(rng, T, B, 4 * H))
        got = (torch.ops.morgana.rnn_dw_bf16(*args),)
        want = (weight_grad.bf16_weight_grad_reference(*args),)
        f32 = (torch.einsum('tbh,tbg->hg', args[0].bfloat16().float(), args[1])
               .bfloat16().float(),)
        target = torch.ops.morgana.rnn_dw_bf16.default
    _equal(got, want)
    assert _fresh(got, [a for a in args if isinstance(a, torch.Tensor)])
    assert not torch.equal(got[0].float(), f32[0].float())
    _opcheck(target, args)


class _Lstm(torch.nn.Module):
    def forward(self, x, w_ih, w_hh, b, seq_len):
        y, _ = lstm_ops.lstm_layer(x, w_ih, w_hh, b, b, seq_len=seq_len)
        return lstm_ops.lstm_layer(y, w_hh, w_hh, b, b, seq_len=seq_len)[0]


class _Gru(torch.nn.Module):
    def forward(self, x, w_ih, w_hh, b, seq_len):
        return gru_ops.gru_layer(x, w_ih, w_hh, b, b, seq_len=seq_len)[0]


class _Attention(torch.nn.Module):
    def forward(self, q, seq_len):
        return fa.flash_attention(q, q, q, seq_len=seq_len, causal=True, window=4)


def _export_case(name, rng):
    x, seq_len = _arr(rng, B, T, H), torch.tensor([T, 5, 1])
    if name == 'lstm':
        return _Lstm(), (x, _arr(rng, H, 4 * H), _arr(rng, H, 4 * H), _arr(rng, 4 * H), seq_len)
    if name == 'gru':
        return _Gru(), (x, _arr(rng, H, 3 * H), _arr(rng, H, 3 * H), _arr(rng, 3 * H), seq_len)
    return _Attention(), (_arr(rng, B, 2, T, 16), seq_len)


@pytest.mark.parametrize('name,nodes', [('lstm', ['morgana.lstm_fwd.default'] * 2),
                                        ('gru', ['morgana.gru_fwd.default']),
                                        ('attention', ['morgana.attn_fwd.default'])])
def test_export_holds_one_node_per_kernel_call(name, nodes):
    module, args = _export_case(name, np.random.default_rng(4))
    with torch.no_grad():
        program = torch.export.export(module, args, strict=False)
        assert [str(n.target) for n in program.graph.nodes
                if str(n.target).startswith('morgana.')] == nodes
        torch.testing.assert_close(program.module()(*args), module(*args), rtol=0, atol=0)


def test_training_goes_through_the_backward_ops(monkeypatch):
    """With a gradient, the LSTM and GRU layers call their backward ops (the
    plain K2 and K4 on the CPU), as the kernels run on the card."""
    calls = []
    for module, name in ((lstm_ops, 'lstm_backward'), (gru_ops, '_layer_backward')):
        real = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, _r=real, _n=name: calls.append(_n) or _r(*a))
    rng = np.random.default_rng(5)
    x = _arr(rng, B, T, H).requires_grad_(True)
    y, _ = lstm_ops.lstm_layer(x, _arr(rng, H, 4 * H), _arr(rng, H, 4 * H), _arr(rng, 4 * H),
                               _arr(rng, 4 * H), seq_len=torch.tensor([T, 5, 1]))
    z, _ = gru_ops.gru_layer(y, _arr(rng, H, 3 * H), _arr(rng, H, 3 * H).requires_grad_(True),
                             _arr(rng, 3 * H), _arr(rng, 3 * H), seq_len=torch.tensor([T, 5, 1]))
    z.sum().backward()
    assert calls == ['_layer_backward', 'lstm_backward'] and x.grad is not None

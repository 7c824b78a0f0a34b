"""The port's optimisers (``morgana_tpu_torch.training.build_optimizer``:
adam, adamw, sgd with and without momentum and Nesterov, lamb) against
``morgana_tpu.training.build_optimizer``'s optax chains on the CPU, and
their ``.train.pkl`` optimiser state between the two packages.

Tolerance: 1e-6 absolute on parameters of order 1 after five steps at
learning rates up to 0.05 (f32 arithmetic in a different order: a few ulps
a step), the bar of ``test_torch_train_parts.py``'s Adam test. The sidecar
round trip is exact: the state crosses as numpy f32 arrays.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from morgana_tpu import checkpointing as jckpt
from morgana_tpu.training import apply_updates as japply_updates
from morgana_tpu.training import build_optimizer as jbuild_optimizer

from morgana_tpu_torch import checkpointing as tckpt
from morgana_tpu_torch.training import TrainLoop as TLoop
from morgana_tpu_torch.training import apply_updates as tapply_updates
from morgana_tpu_torch.training import build_optimizer as tbuild_optimizer

ATOL = 1e-6
LRS = [0.01, 0.05, 0.005, 0.02, 0.01]
# name: (optimizer, settings); each also runs with weight decay and clipping.
OPTIMIZERS = {
    'adam': ('adam', {}),
    'adamw': ('adamw', {'b1': 0.8, 'b2': 0.99, 'eps': 1e-6}),
    'sgd': ('sgd', {}),
    'sgd_momentum': ('sgd', {'momentum': 0.9}),
    'sgd_nesterov': ('sgd', {'momentum': 0.9, 'nesterov': True}),
    'lamb': ('lamb', {}),
}
CHAINS = {'plain': {}, 'decay_clip': {'weight_decay': 0.01, 'grad_clip_norm': 1.5}}


def _problem(seed, zero_param=False):
    """Parameters of a few shapes and five steps of gradients, some above
    the clip norm; with ``zero_param`` one parameter is all zeros (LAMB's
    trust ratio is then 1 for it)."""
    rng = np.random.default_rng(seed)
    init = {'w': rng.normal(size=(4, 3)).astype(np.float32),
            'b': rng.normal(size=(3,)).astype(np.float32),
            'v': rng.normal(size=(2, 2, 3)).astype(np.float32)}
    if zero_param:
        init['b'][:] = 0
    grads = [{k: (scale * rng.normal(size=v.shape)).astype(np.float32) for k, v in init.items()}
             for scale in (2.0, 0.1, 3.0, 0.5, 1.0)]
    return init, grads


def _jax_steps(opt, params, state, grads, lrs):
    for g, lr in zip(grads, lrs):
        params, state, _, _ = japply_updates(opt, 0., params, state, None,
                                             {k: jnp.asarray(v) for k, v in g.items()},
                                             jnp.float32(lr))
    return params, state


def _port_steps(opt, params, state, grads, lrs):
    for g, lr in zip(grads, lrs):
        tapply_updates(opt, 0., params, state, None, lr,
                       grads=[torch.from_numpy(g[k].copy()) for k in params])


@pytest.mark.parametrize('chain', list(CHAINS))
@pytest.mark.parametrize('case', list(OPTIMIZERS))
def test_optimizer_matches_jax_over_five_steps(case, chain):
    name, settings = OPTIMIZERS[case]
    init, grads = _problem(6, zero_param=name == 'lamb')
    jopt = jbuild_optimizer(name, **CHAINS[chain], **settings)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jparams, _ = _jax_steps(jopt, jparams, jopt.init(jparams), grads, LRS)

    topt = tbuild_optimizer(name, **CHAINS[chain], **settings)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    _port_steps(topt, tparams, topt.init(list(tparams.values())), grads, LRS)
    for k in init:
        np.testing.assert_allclose(tparams[k].detach().numpy(), np.asarray(jparams[k]),
                                   atol=ATOL, err_msg=k)
    if name == 'lamb':        # the zero parameter moved by the AdamW update itself
        assert float(np.abs(np.asarray(jparams['b'])).max()) > 0


def test_lamb_scales_each_update_by_its_trust_ratio():
    """One LAMB step's update is the AdamW update times ‖p‖/‖u‖ per
    parameter (1 for the zero parameter), as optax computes it."""
    init, grads = _problem(8, zero_param=True)
    g = {k: jnp.asarray(v) for k, v in grads[0].items()}
    p = {k: jnp.asarray(v) for k, v in init.items()}
    jopt = jbuild_optimizer('lamb', weight_decay=0.01)
    want, _ = jopt.update(g, jopt.init(p), p)
    topt = tbuild_optimizer('lamb', weight_decay=0.01)
    tp = [torch.from_numpy(v.copy()) for v in init.values()]
    got = topt.update([torch.from_numpy(v.copy()) for v in grads[0].values()], topt.init(tp), tp)
    adamw = optax.chain(optax.scale_by_adam(), optax.add_decayed_weights(0.01))
    plain, _ = adamw.update(g, adamw.init(p), p)
    for k, u in zip(init, got):
        np.testing.assert_allclose(u.numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-7)
        ratio = 1.0 if k == 'b' else float(np.linalg.norm(init[k]) /
                                           np.linalg.norm(np.asarray(plain[k])))
        np.testing.assert_allclose(u.numpy(), ratio * np.asarray(plain[k]), rtol=1e-5,
                                   atol=1e-7)


def test_nesterov_needs_momentum_and_settings_are_checked():
    with pytest.raises(ValueError, match='nesterov'):
        tbuild_optimizer('sgd', nesterov=True)
    with pytest.raises(TypeError, match='b1'):
        tbuild_optimizer('sgd', b1=0.5)
    assert tbuild_optimizer('sgd', weight_decay=0.1, momentum=0.9).chain == ('decay', 'trace')
    assert tbuild_optimizer('adamw', weight_decay=0.1, grad_clip_norm=1.).chain == \
        ('clip', 'adam', 'decay')


class _Params(torch.nn.Module):
    """A module whose parameter names are the problem's."""

    def __init__(self, init):
        super().__init__()
        for k, v in init.items():
            self.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v.copy())))


@pytest.mark.parametrize('case', list(OPTIMIZERS))
def test_sidecar_state_crosses_jax_port_jax(case, tmp_path):
    """JAX trains 3 steps and writes the sidecar; the port's loop takes it
    over and trains 1 step (as JAX does from the same state); the port's
    sidecar, read by JAX's plain pickle, has the JAX optimiser's tree
    structure and its values, and JAX's last step from it matches the
    port's."""
    name, settings = OPTIMIZERS[case]
    init, grads = _problem(9, zero_param=name == 'lamb')
    jopt = jbuild_optimizer(name, weight_decay=0.01, **settings)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jparams, jstate = _jax_steps(jopt, jparams, jopt.init(jparams), grads[:3], LRS[:3])
    path = str(tmp_path / 'epoch_1.train.pkl')
    jckpt.save_training_state(path, params=jparams, opt_state=jstate, step=3)

    loop = TLoop(_Params({k: np.asarray(v) for k, v in jparams.items()}),
                 tbuild_optimizer(name, weight_decay=0.01, **settings))
    loop.restore_jax_state(tckpt.load_training_state(path))
    assert loop.step_count == 3
    _port_steps(loop.optimizer, loop.params, loop.opt_state, grads[3:4], LRS[3:4])
    jparams, jstate = _jax_steps(jopt, jparams, jstate, grads[3:4], LRS[3:4])
    for k in init:
        np.testing.assert_allclose(loop.params[k].detach().numpy(), np.asarray(jparams[k]),
                                   atol=ATOL)

    out = str(tmp_path / 'epoch_2.train.pkl')
    tckpt.save_training_state(out, **loop.jax_state())
    back = jckpt.load_training_state(out)['opt_state']
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(jstate)
    assert [type(s) for s in back] == [type(s) for s in jstate]
    for got, want in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jstate)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL)
        assert np.asarray(got).dtype == np.asarray(want).dtype
    ported = {k: jnp.asarray(loop.params[k].detach().numpy()) for k in init}
    jnext, _ = _jax_steps(jopt, ported, back, grads[4:], LRS[4:])
    _port_steps(loop.optimizer, loop.params, loop.opt_state, grads[4:], LRS[4:])
    for k in init:
        np.testing.assert_allclose(loop.params[k].detach().numpy(), np.asarray(jnext[k]),
                                   atol=ATOL)


def test_a_sidecar_of_another_optimizer_is_refused(tmp_path):
    """An SGD-momentum sidecar does not resume an Adam run: its trace would
    be dropped silently."""
    init, grads = _problem(4)
    jopt = jbuild_optimizer('sgd', momentum=0.9)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    _, jstate = _jax_steps(jopt, jparams, jopt.init(jparams), grads[:1], LRS[:1])
    path = str(tmp_path / 'epoch_1.train.pkl')
    jckpt.save_training_state(path, params=jparams, opt_state=jstate, step=1)
    loop = TLoop(_Params(init), tbuild_optimizer('adam'))
    with pytest.raises(ValueError, match='does not match optimizer'):
        loop.restore_jax_state(tckpt.load_training_state(path))

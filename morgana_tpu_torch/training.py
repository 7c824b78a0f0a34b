"""Train, eval and predict steps (counterpart of ``morgana_tpu/training.py``).

One train step moves a collated batch to the model's device, runs forward
(the loss and the metrics' partials), backward (on the GPU, kernel K2 under
each LSTM layer, K4 under each GRU layer and the attention backward under
each attention layer) and the optimiser, plus the EMA
when it is on. It makes no host round trip: the loss comes back as a device
scalar and the metrics merge lazily.

The optimiser is Adam with the L2 term added to the gradient (optax's
``add_decayed_weights`` then ``scale_by_adam``, torch ``Adam(weight_decay=)``
semantics), after an optional clip of the global gradient norm written as
optax's ``clip_by_global_norm``. It is ``torch.optim.Adam``: the JAX package
computes Adam in XLA, outside any Pallas kernel.
"""
import numpy as np
import torch

from morgana_tpu_torch import checkpointing as ckpt
from morgana_tpu_torch import nn as mnn
from morgana_tpu_torch.data import device_features

__all__ = ['SUPPORTED_OPTIMIZERS', 'Optimizer', 'build_optimizer', 'clip_by_global_norm',
           'apply_updates', 'TrainLoop']

#: The JAX package's optimiser names (``training.py:112``); the port has 'adam'.
SUPPORTED_OPTIMIZERS = ('adam', 'adamw', 'sgd', 'lamb')


class Optimizer(object):
    """Settings of the gradient transform; :meth:`init` makes its state for a
    list of parameters. The learning rate is given per step."""

    def __init__(self, weight_decay=0., b1=0.9, b2=0.999, eps=1e-8, grad_clip_norm=0.):
        self.weight_decay = float(weight_decay)
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)
        self.grad_clip_norm = float(grad_clip_norm)

    def init(self, params):
        return torch.optim.Adam(params, lr=0., betas=(self.b1, self.b2), eps=self.eps,
                                weight_decay=self.weight_decay)


def build_optimizer(name='adam', weight_decay=0., b1=0.9, b2=0.999, eps=1e-8,
                    grad_clip_norm=0.):
    r"""The optimiser of ``training.py:115``. ``'adam'``: Adam with L2 added
    to the gradient. Another optimiser's setting (``momentum``, ``nesterov``)
    is a ``TypeError``, never accepted and ignored."""
    if name not in SUPPORTED_OPTIMIZERS:
        raise ValueError(f'Unknown optimizer {name!r}; supported: {SUPPORTED_OPTIMIZERS}')
    if name != 'adam':
        raise NotImplementedError(f'optimizer {name!r} is not ported yet; the port has adam')
    return Optimizer(weight_decay, b1, b2, eps, grad_clip_norm)


def clip_by_global_norm(grads, max_norm):
    """Scales ``grads`` in place by ``max_norm / norm`` when their global L2
    norm is at least ``max_norm`` (optax's ``clip_by_global_norm``; unlike
    ``torch.nn.utils.clip_grad_norm_`` it adds no 1e-6). No host sync."""
    norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))


def apply_updates(optimizer, ema_decay, params, opt_state, ema_params, lr):
    """The optimiser and EMA tail of a step (``training.py:50``). ``params``
    and ``ema_params`` are ``{name: parameter}``, the gradients in ``.grad``;
    both are updated in place."""
    if optimizer.grad_clip_norm:
        clip_by_global_norm([p.grad for p in params.values() if p.grad is not None],
                            optimizer.grad_clip_norm)
    for group in opt_state.param_groups:
        group['lr'] = float(lr)
    opt_state.step()
    if ema_decay:
        with torch.no_grad():
            for name, value in mnn.ema_update(ema_params, params, ema_decay).items():
                ema_params[name].copy_(value)


def _check_names(what, saved, params):
    if set(saved) != set(params):
        raise KeyError(f'{what} of the sidecar do not match the model: '
                       f'missing={sorted(set(params) - set(saved))}, '
                       f'unexpected={sorted(set(saved) - set(params))}')


class TrainLoop(object):
    r"""Training state of one model: the optimiser state and, with
    ``ema_decay``, the parameters of ``ema_model`` as the moving average.
    The model's own parameters are trained in place, so the model is always
    current and there is nothing like the JAX loop's ``sync_model`` to call.

    Dropout noise of step ``n`` (``Dropout`` layers and attention
    probabilities) comes from a generator seeded with ``(seed, n)``, so it
    does not depend on what ran before (``training.py:255``).
    """

    def __init__(self, model, optimizer, ema_decay=0., seed=1234567890, ema_model=None):
        self.model = model
        self.optimizer = optimizer
        self.ema_decay = float(ema_decay)
        self.ema_model = ema_model
        self.params = dict(model.named_parameters())
        self.opt_state = optimizer.init(list(self.params.values()))
        self.ema_params = None
        if self.ema_decay:
            if ema_model is None:
                raise ValueError('ema_decay > 0 needs an ema_model to hold the average')
            # The average starts from the EMA model's own (loaded) parameters.
            self.ema_params = dict(ema_model.named_parameters())
        self.seed = int(seed)
        self.step_count = 0
        self.last_step_applied = True

    @property
    def device(self):
        return next(iter(self.params.values())).device

    def restore_jax_state(self, state):
        """Takes over the training state of a JAX sidecar, as
        :func:`~morgana_tpu_torch.checkpointing.load_training_state` returns
        it (``experiment_builder.py:756-778``): Adam's ``count``, ``mu`` and
        ``nu``, by parameter name, become ``torch.optim.Adam``'s ``step``,
        ``exp_avg`` and ``exp_avg_sq``; the EMA parameters (when this loop
        keeps an average) and the step count, which seeds dropout, are
        copied."""
        opt_state = state.get('opt_state')
        if opt_state is not None:
            # optax.chain's state is a plain tuple of its transforms' states.
            chain = (opt_state,) if hasattr(opt_state, '_fields') else tuple(opt_state)
            adam = [s for s in chain if isinstance(s, ckpt.AdamState)]
            if len(adam) != 1:
                raise ValueError(f'the sidecar optimiser state {[type(s).__name__ for s in chain]} '
                                 'holds no single Adam state')
            count, mu, nu = adam[0]
            _check_names('Adam moments', mu, self.params)
            saved = self.opt_state.state_dict()
            saved['state'] = {i: {'step': torch.tensor(float(np.asarray(count))),
                                  'exp_avg': torch.from_numpy(np.array(mu[name])),
                                  'exp_avg_sq': torch.from_numpy(np.array(nu[name]))}
                              for i, name in enumerate(self.params)}
            self.opt_state.load_state_dict(saved)
        ema_params = state.get('ema_params')
        if ema_params is not None and self.ema_decay:
            _check_names('EMA parameters', ema_params, self.ema_params)
            with torch.no_grad():
                for name, value in self.ema_params.items():
                    value.copy_(torch.from_numpy(np.array(ema_params[name])))
        self.step_count = int(state.get('step', 0))

    def jax_state(self):
        """The training state as the JAX loop keeps it, the inverse of
        :meth:`restore_jax_state`: ``{params, opt_state, ema_params, step}``
        by parameter name in numpy, the optimiser state optax's chain of
        ``clip_by_global_norm`` (when clipping), ``add_decayed_weights``
        (with an L2 term) and ``scale_by_adam`` (``training.py:115``), the
        first two stateless. Adam's ``count`` is the steps it has taken,
        ``mu`` and ``nu`` its moments (zero before a parameter's first
        step)."""
        state = self.opt_state.state
        mu, nu, count = {}, {}, 0
        for name, param in self.params.items():
            moments = state.get(param, {})
            count = int(moments['step']) if 'step' in moments else count
            for out, key in ((mu, 'exp_avg'), (nu, 'exp_avg_sq')):
                value = moments.get(key)
                out[name] = (np.zeros(tuple(param.shape), np.float32) if value is None
                             else value.detach().cpu().numpy())
        stateless = bool(self.optimizer.grad_clip_norm) + bool(self.optimizer.weight_decay)
        chain = [ckpt.EmptyState()] * stateless
        chain.append(ckpt.AdamState(np.asarray(count, np.int32), mu, nu))
        return {'params': mnn.state_dict(self.model), 'opt_state': tuple(chain),
                'ema_params': None if self.ema_params is None else mnn.state_dict(self.ema_model),
                'step': self.step_count}

    def _set_generators(self, model):
        """This step's generator, given to every module of ``model`` that
        draws noise (one with a ``generator`` attribute: dropout, attention
        dropout, the VAE's posterior sample)."""
        seed = int(np.random.SeedSequence([self.seed, self.step_count]).generate_state(1)[0])
        generator = torch.Generator(device=self.device).manual_seed(seed)
        for module in model.modules():
            if hasattr(module, 'generator'):
                module.generator = generator

    def _batch(self, features):
        """A collated batch on the device, with ``global_step``, the step
        count as a device int32 scalar (``training.py:297``) that a loss may
        schedule on (the VAE's KL annealing). Filled on the device: no host
        sync."""
        batch = device_features(features, self.device)
        batch['global_step'] = torch.full((), self.step_count, dtype=torch.int32,
                                          device=self.device)
        return batch

    def train_step(self, features, lr):
        """One training step on a collated (numpy) batch. Returns ``(loss,
        outputs)`` as device tensors, detached; no host sync. Auxiliary
        losses that layers register (the mixture-of-experts balance term)
        join the loss that is optimised and returned (``training.py:41``)."""
        batch = self._batch(features)
        self.model.train()
        self._set_generators(self.model)
        self.opt_state.zero_grad(set_to_none=True)
        with mnn.collect_aux_losses():
            loss, outputs = self.model(batch)
            loss = loss + mnn.collected_aux_loss()
        loss.backward()
        apply_updates(self.optimizer, self.ema_decay, self.params, self.opt_state,
                      self.ema_params, lr)
        self.last_step_applied = True
        self.step_count += 1
        return loss.detach(), {k: v.detach() for k, v in outputs.items()}

    def _model_for(self, use_ema):
        if use_ema:
            if self.ema_params is None:
                raise ValueError('use_ema=True but this loop tracks no EMA parameters '
                                 '(construct with ema_decay > 0)')
            return self.ema_model
        return self.model

    def eval_step(self, features, use_ema=False):
        """Loss and outputs without a gradient (dropout off; the loss alone,
        without auxiliary terms), ``global_step`` in the batch as in
        training (``training.py:693``)."""
        model = self._model_for(use_ema)
        model.eval()
        self._set_generators(model)
        with torch.no_grad():
            loss, outputs = model(self._batch(features))
        return loss, outputs

    def predict_step(self, features, use_ema=False):
        """Outputs without a gradient (dropout off)."""
        model = self._model_for(use_ema)
        model.eval()
        with torch.no_grad():
            return model.predict(device_features(features, self.device))

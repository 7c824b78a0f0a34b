"""Train, eval and predict steps (counterpart of ``morgana_tpu/training.py``).

One train step moves a collated batch to the model's device, runs forward
(the loss and the metrics' partials), backward (on the GPU, kernel K2 under
each LSTM layer, K4 under each GRU layer and the attention backward under
each attention layer) and the optimiser, plus the EMA
when it is on. It makes no host round trip: the loss comes back as a device
scalar and the metrics merge lazily.

The optimisers are optax's chains (``training.py:115-166``) written as one
functional update over the parameter list (``torch._foreach_*`` ops): an
optional clip of the global gradient norm (``clip_by_global_norm``), then

- ``'adam'``: ``add_decayed_weights`` then ``scale_by_adam`` (L2 added to the
  gradient, torch ``Adam(weight_decay=)`` semantics);
- ``'adamw'``: ``scale_by_adam`` then ``add_decayed_weights`` (decoupled);
- ``'sgd'``: ``add_decayed_weights`` then ``trace(momentum, nesterov)``;
- ``'lamb'``: ``scale_by_adam``, ``add_decayed_weights``, then
  ``scale_by_trust_ratio`` (each parameter's update scaled by ``‖p‖/‖u‖``,
  1 where either norm is 0).

The chain returns the update ``u`` before the learning rate; the step applies
``p ← p − lr·u``. The JAX package computes them in XLA, outside any Pallas
kernel, and so does the port: they launch none of the port's kernels.

With ``grad_accum_steps = N > 1`` (``training.py:310-365``, ``:728``) each
micro-batch's gradient, from an unscaled backward, is added as ``n_items · g``
into an f32 accumulator; every N-th call (or one with ``force_apply``) divides
by the cycle's item count and applies the chain and the EMA once.
``log_norms`` registers ``grad_norm`` (raw, before clipping), ``param_norm``
and ``update_norm`` (``lr·‖u‖``) in the ``train`` collection and adds them on
applied steps only (``training.py:91``).
"""
import numpy as np
import torch

from morgana_tpu_torch import checkpointing as ckpt
from morgana_tpu_torch import metrics as metrics_mod
from morgana_tpu_torch import nn as mnn
from morgana_tpu_torch.data import device_features

__all__ = ['SUPPORTED_OPTIMIZERS', 'Optimizer', 'build_optimizer', 'global_norm',
           'apply_updates', 'batch_items', 'TrainLoop', 'NORM_METRICS']

#: The JAX package's optimiser names (``training.py:112``).
SUPPORTED_OPTIMIZERS = ('adam', 'adamw', 'sgd', 'lamb')
#: The settings each optimiser reads; another is a ``TypeError``.
_SETTINGS = {'adam': ('b1', 'b2', 'eps'), 'adamw': ('b1', 'b2', 'eps'),
             'lamb': ('b1', 'b2', 'eps'), 'sgd': ('momentum', 'nesterov')}
#: The diagnostics of ``log_norms``, in the order they are registered.
NORM_METRICS = ('grad_norm', 'param_norm', 'update_norm')


def global_norm(tensors):
    """optax's ``global_norm``: the L2 norm of all ``tensors`` together, a
    device scalar (no host sync)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))


class Optimizer(object):
    """An optax chain of gradient transforms, named by :attr:`chain`:
    ``'clip'``, ``'decay'`` (``add_decayed_weights``), ``'adam'``
    (``scale_by_adam``), ``'trace'``, ``'trust'`` (``scale_by_trust_ratio``)
    or ``'identity'``. :meth:`init` makes its state for a list of parameters,
    one entry a transform (a dict for Adam and the trace, None for the
    stateless ones); :meth:`update` updates it in place and returns the
    pre-lr update."""

    def __init__(self, name='adam', weight_decay=0., b1=0.9, b2=0.999, eps=1e-8,
                 grad_clip_norm=0., momentum=0., nesterov=False):
        if name == 'sgd' and nesterov and not momentum:
            # torch.optim.SGD raises the same way (training.py:152).
            raise ValueError('SGD: nesterov=True requires momentum > 0')
        self.name = name
        self.weight_decay = float(weight_decay)
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)
        self.grad_clip_norm = float(grad_clip_norm)
        self.momentum, self.nesterov = float(momentum), bool(nesterov)
        decay = ['decay'] if self.weight_decay else []
        chain = ['clip'] if self.grad_clip_norm else []
        chain += {'adam': decay + ['adam'], 'adamw': ['adam'] + decay,
                  'sgd': decay + (['trace'] if self.momentum else []),
                  'lamb': ['adam'] + decay + ['trust']}[name]
        self.chain = tuple(chain or ['identity'])

    def init(self, params):
        """The chain's state for ``params`` (a list, or a dict's values)."""
        params = list(params.values() if isinstance(params, dict) else params)

        def zeros():
            return [torch.zeros_like(p, memory_format=torch.preserve_format) for p in params]

        return [{'count': 0, 'mu': zeros(), 'nu': zeros()} if kind == 'adam'
                else {'trace': zeros()} if kind == 'trace' else None for kind in self.chain]

    def update(self, grads, state, params):
        """The chain's update of ``grads`` (a list of tensors, left as they
        are) for ``params``, before the learning rate; ``state`` (from
        :meth:`init`) is updated in place."""
        u = list(grads)
        for kind, st in zip(self.chain, state):
            if kind == 'clip':
                u = _clipped(u, self.grad_clip_norm)
            elif kind == 'decay':
                u = torch._foreach_add(u, params, alpha=self.weight_decay)
            elif kind == 'adam':
                u = self._adam(u, st)
            elif kind == 'trace':
                # optax.trace: t = g + decay * t; u = t, or g + decay * t
                # with nesterov.
                torch._foreach_mul_(st['trace'], self.momentum)
                torch._foreach_add_(st['trace'], u)
                u = (torch._foreach_add(u, torch._foreach_mul(st['trace'], self.momentum))
                     if self.nesterov else list(st['trace']))
            elif kind == 'trust':
                u = _trust_ratio_scaled(u, params)
        return u

    def _adam(self, u, st):
        """optax.scale_by_adam: the moments, their bias corrections at the
        incremented count, ``mu_hat / (sqrt(nu_hat) + eps)``."""
        st['count'] += 1
        mu, nu = st['mu'], st['nu']
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, u, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, u, u, value=1.0 - self.b2)
        mu_hat = torch._foreach_div(mu, 1.0 - self.b1 ** st['count'])
        denom = torch._foreach_sqrt(torch._foreach_div(nu, 1.0 - self.b2 ** st['count']))
        torch._foreach_add_(denom, self.eps)
        return torch._foreach_div(mu_hat, denom)


def _clipped(grads, max_norm):
    """optax's ``clip_by_global_norm``: ``grads`` scaled by ``max_norm /
    norm`` when their global norm is at least ``max_norm`` (no 1e-6, unlike
    ``torch.nn.utils.clip_grad_norm_``); new tensors, no host sync."""
    norm = global_norm(grads)
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    return torch._foreach_mul(grads, scale)


def _trust_ratio_scaled(updates, params):
    """optax.scale_by_trust_ratio (trust coefficient 1, eps 0): each update
    times ``‖p‖ / ‖u‖``, or 1 where either norm is 0."""
    p_norm = torch.stack(torch._foreach_norm(params))
    u_norm = torch.stack(torch._foreach_norm(updates))
    ratio = torch.where((p_norm == 0) | (u_norm == 0), torch.ones_like(p_norm), p_norm / u_norm)
    return [u * r for u, r in zip(updates, ratio.unbind())]


def build_optimizer(name='adam', weight_decay=0., grad_clip_norm=0., **settings):
    r"""The optimiser of ``training.py:115`` (see the module docstring):
    ``'adam'``, ``'adamw'``, ``'sgd'`` or ``'lamb'``; ``settings`` are
    ``b1``, ``b2``, ``eps`` for the Adam family and ``momentum``,
    ``nesterov`` for SGD. A setting the chosen optimiser does not read is a
    ``TypeError``, never accepted and ignored (the JAX package ignores
    it)."""
    if name not in SUPPORTED_OPTIMIZERS:
        raise ValueError(f'Unknown optimizer {name!r}; supported: {SUPPORTED_OPTIMIZERS}')
    ignored = sorted(set(settings) - set(_SETTINGS[name]))
    if ignored:
        raise TypeError(f'optimizer {name!r} does not read {ignored}; it takes '
                        f'{list(_SETTINGS[name])}')
    return Optimizer(name, weight_decay=weight_decay, grad_clip_norm=grad_clip_norm, **settings)


def apply_updates(optimizer, ema_decay, params, opt_state, ema_params, lr, grads=None):
    """The optimiser and EMA tail of a step (``training.py:50``): ``p ← p −
    lr·u`` with ``u`` the chain's update of ``grads`` (default: each
    parameter's ``.grad``; a parameter without one counts zero, as JAX's
    gradient of an unused parameter), then the EMA. ``params`` and
    ``ema_params`` are ``{name: parameter}``, updated in place. Returns the
    gradients and the updates, lists in ``params``' order."""
    plist = list(params.values())
    with torch.no_grad():
        if grads is None:
            grads = [p.grad for p in plist]
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(plist, grads)]
        updates = optimizer.update(grads, opt_state, plist)
        torch._foreach_add_(plist, updates, alpha=-float(lr))
        if ema_decay:
            for name, value in mnn.ema_update(ema_params, params, ema_decay).items():
                ema_params[name].copy_(value)
    return grads, updates


def batch_items(batch):
    """Items in a collated batch: the leading size of its first array
    (``training.py:168``)."""
    for value in batch.values():
        if hasattr(value, 'shape') and len(value.shape) >= 1:
            return int(value.shape[0])
    return 1


def _check_names(what, saved, params):
    if set(saved) != set(params):
        raise KeyError(f'{what} of the sidecar do not match the model: '
                       f'missing={sorted(set(params) - set(saved))}, '
                       f'unexpected={sorted(set(saved) - set(params))}')


class TrainLoop(object):
    r"""Training state of one model: the optimiser state, the gradient
    accumulator and, with ``ema_decay``, the parameters of ``ema_model`` as
    the moving average. The model's own parameters are trained in place, so
    the model is always current and there is nothing like the JAX loop's
    ``sync_model`` to call.

    Dropout noise of step ``n`` (``Dropout`` layers and attention
    probabilities) comes from a generator seeded with ``(seed, n)``, so it
    does not depend on what ran before (``training.py:255``). ``n`` counts
    every call of :meth:`train_step`, micro-batches included, as in JAX.
    """

    def __init__(self, model, optimizer, ema_decay=0., seed=1234567890, ema_model=None,
                 grad_accum_steps=1, log_norms=False):
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
        self.grad_accum_steps = max(1, int(grad_accum_steps or 1))
        self.log_norms = bool(log_norms)
        if self.log_norms:
            for name in NORM_METRICS:
                if name not in model.metrics.collections['train']:
                    model.metrics.add_metrics(('train',), **{name: metrics_mod.Mean()})
        # The open accumulation cycle: item-weighted gradient sums (f32), its
        # micro-batches and items so far.
        self._acc_grads = None
        self._micro_count = 0
        self._acc_items = 0
        # False after a micro-batch that only accumulated; batch-level LR
        # schedules step on applied updates only.
        self.last_step_applied = True

    @property
    def device(self):
        return next(iter(self.params.values())).device

    def restore_jax_state(self, state):
        """Takes over the training state of a sidecar of either package, as
        :func:`~morgana_tpu_torch.checkpointing.load_training_state` returns
        it (``experiment_builder.py:756-778``): the optimiser chain's Adam
        (``count``, ``mu``, ``nu``) and trace states by parameter name, the
        EMA parameters (when this loop keeps an average) and the step count,
        which seeds dropout. The stateless transforms carry nothing; a
        stateful one this chain lacks, or misses, is a ``ValueError``."""
        opt_state = state.get('opt_state')
        if opt_state is not None:
            # optax.chain's state is a plain tuple of its transforms' states.
            chain = (opt_state,) if hasattr(opt_state, '_fields') else tuple(opt_state)
            saved = {kind: [s for s in chain if isinstance(s, cls)]
                     for kind, cls in (('adam', ckpt.AdamState), ('trace', ckpt.TraceState))}
            for kind, states in saved.items():
                if len(states) != self.optimizer.chain.count(kind):
                    raise ValueError(
                        f'the sidecar optimiser state {[type(s).__name__ for s in chain]} does '
                        f"not match optimizer {self.optimizer.name!r} "
                        f'(chain {list(self.optimizer.chain)})')
            device = self.device

            def tensors(what, values):
                _check_names(what, values, self.params)
                return [torch.from_numpy(np.array(values[name])).to(device)
                        for name in self.params]

            for kind, st in zip(self.optimizer.chain, self.opt_state):
                if kind == 'adam':
                    count, mu, nu = saved['adam'][0]
                    st.update(count=int(np.asarray(count)), mu=tensors('Adam moments', mu),
                              nu=tensors('Adam moments', nu))
                elif kind == 'trace':
                    st['trace'] = tensors('Momentum traces', saved['trace'][0].trace)
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
        by parameter name in numpy, the optimiser state optax's chain
        (``training.py:115``): ``ScaleByAdamState`` for Adam (``count`` the
        steps it has taken, ``mu`` and ``nu`` its moments), ``TraceState``
        for SGD's momentum, ``EmptyState`` for the stateless transforms."""
        def arrays(tensors):
            return {name: t.detach().cpu().numpy() for name, t in zip(self.params, tensors)}

        chain = []
        for kind, st in zip(self.optimizer.chain, self.opt_state):
            if kind == 'adam':
                chain.append(ckpt.AdamState(np.asarray(st['count'], np.int32), arrays(st['mu']),
                                            arrays(st['nu'])))
            elif kind == 'trace':
                chain.append(ckpt.TraceState(arrays(st['trace'])))
            else:
                chain.append(ckpt.EmptyState())
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

    def train_step(self, features, lr, force_apply=False):
        """One training step on a collated (numpy) batch. Returns ``(loss,
        outputs)`` as device tensors, detached; no host sync. Auxiliary
        losses that layers register (the mixture-of-experts balance term)
        join the loss that is optimised and returned (``training.py:41``).

        With ``grad_accum_steps = N > 1`` only every N-th call applies the
        optimiser and the EMA, to the item-weighted mean of the cycle's
        gradients; ``force_apply`` closes a shorter cycle (the epoch's last
        batch). :attr:`last_step_applied` says which kind of call this was."""
        batch = self._batch(features)
        self.model.train()
        self._set_generators(self.model)
        for p in self.params.values():
            p.grad = None
        with mnn.collect_aux_losses():
            loss, outputs = self.model(batch)
            loss = loss + mnn.collected_aux_loss()
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params.values()]
        if self.grad_accum_steps > 1:
            items = batch_items(batch)
            with torch.no_grad():
                if self._acc_grads is None:
                    self._acc_grads = [torch.zeros_like(p, dtype=torch.float32)
                                       for p in self.params.values()]
                if self._micro_count + 1 < self.grad_accum_steps and not force_apply:
                    torch._foreach_add_(self._acc_grads, grads, alpha=float(items))
                    self._micro_count += 1
                    self._acc_items += items
                    self.last_step_applied = False
                else:
                    # (acc + n·g) / items of the cycle (training.py:358).
                    grads = torch._foreach_add(self._acc_grads, grads, alpha=float(items))
                    torch._foreach_mul_(grads, 1.0 / (self._acc_items + items))
                    self._apply(grads, lr)
                    torch._foreach_zero_(self._acc_grads)
                    self._micro_count = self._acc_items = 0
        else:
            self._apply(grads, lr)
        self.step_count += 1
        return loss.detach(), {k: v.detach() for k, v in outputs.items()}

    def _apply(self, grads, lr):
        """The optimiser and EMA on ``grads``, and with ``log_norms`` the
        three norms of this applied step into the ``train`` metrics."""
        grads, updates = apply_updates(self.optimizer, self.ema_decay, self.params,
                                       self.opt_state, self.ema_params, lr, grads)
        self.last_step_applied = True
        if self.log_norms:
            with torch.no_grad():
                self.model.metrics.accumulate(
                    'train', grad_norm=global_norm(grads),
                    param_norm=global_norm(self.params.values()),
                    update_norm=float(lr) * global_norm(updates))

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

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
from torch.utils._pytree import tree_flatten, tree_unflatten

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

    def update(self, grads, state, params, corrections=None):
        """The chain's update of ``grads`` (a list of tensors, left as they
        are) for ``params``, before the learning rate; ``state`` (from
        :meth:`init`) is updated in place. ``corrections`` (the Adam bias
        corrections ``1 - b1^count``, ``1 - b2^count`` at the incremented
        count, as tensors) leave the Adam ``count`` to the caller: a captured
        step reads them from its per-step scalars."""
        u = list(grads)
        for kind, st in zip(self.chain, state):
            if kind == 'clip':
                u = _clipped(u, self.grad_clip_norm)
            elif kind == 'decay':
                u = torch._foreach_add(u, params, alpha=self.weight_decay)
            elif kind == 'adam':
                u = self._adam(u, st, corrections)
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

    def corrections(self, count):
        """Adam's bias corrections at step ``count``: ``1 - b1^count`` and
        ``1 - b2^count`` in float64 on the host, as the uncaptured update
        computes them."""
        return 1.0 - self.b1 ** count, 1.0 - self.b2 ** count

    def _adam(self, u, st, corrections=None):
        """optax.scale_by_adam: the moments, their bias corrections at the
        incremented count, ``mu_hat / (sqrt(nu_hat) + eps)``."""
        if corrections is None:
            st['count'] += 1
            corrections = self.corrections(st['count'])
        mu, nu = st['mu'], st['nu']
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, u, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, u, u, value=1.0 - self.b2)
        mu_hat = torch._foreach_div(mu, corrections[0])
        denom = torch._foreach_sqrt(torch._foreach_div(nu, corrections[1]))
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


def apply_updates(optimizer, ema_decay, params, opt_state, ema_params, lr, grads=None,
                  corrections=None):
    """The optimiser and EMA tail of a step (``training.py:50``): ``p ← p +
    (−lr)·u`` (optax's ``scale(−lr)`` then ``apply_updates``: the scaled
    update rounded, then added) with ``u`` the chain's update of ``grads``
    (default: each parameter's ``.grad``; a parameter without one counts
    zero, as JAX's gradient of an unused parameter), then the EMA. ``lr`` is
    a number or a float32 device scalar; ``corrections`` as in
    :meth:`Optimizer.update`. ``params`` and ``ema_params`` are ``{name:
    parameter}``, updated in place. Returns the gradients and the updates,
    lists in ``params``' order."""
    plist = list(params.values())
    with torch.no_grad():
        if grads is None:
            grads = [p.grad for p in plist]
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(plist, grads)]
        updates = optimizer.update(grads, opt_state, plist, corrections)
        neg_lr = -lr if isinstance(lr, torch.Tensor) else -float(lr)
        torch._foreach_add_(plist, torch._foreach_mul(updates, neg_lr))
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


#: The per-step scalars of a train step, float64 on the device, in this
#: order: the learning rate, Adam's two bias corrections, the inverse item
#: count of an accumulation cycle and the step count (``global_step``).
SCALARS = ('lr', 'bc1', 'bc2', 'inv_items', 'global_step')


class TrainLoop(object):
    r"""Training state of one model: the optimiser state, the gradient
    accumulator and, with ``ema_decay``, the parameters of ``ema_model`` as
    the moving average. The model's own parameters are trained in place, so
    the model is always current and there is nothing like the JAX loop's
    ``sync_model`` to call.

    Dropout noise of step ``n`` (``Dropout`` layers and attention
    probabilities) comes from the loop's generator seeded with ``(seed,
    n)``, so it does not depend on what ran before (``training.py:255``).
    ``n`` counts every call of :meth:`train_step`, micro-batches included, as
    in JAX.

    A step reads its host values (learning rate, Adam's bias corrections,
    an accumulation cycle's inverse item count, the step count) from one
    small float64 tensor on the device, :data:`SCALARS`, and runs without a
    host sync, so the same step is the body of a captured CUDA graph:
    :meth:`train_chain` and :meth:`eval_chain` run ``--steps_per_dispatch``
    chains as graph replays on the GPU (a plain loop on the CPU), bit for bit
    the per-batch loop's steps. The kernels' launch counters count a
    captured step once, at its capture, and not at its replays.
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
        self._generator = None
        self._graphs = None

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

    def _step_generator(self):
        if self._generator is None:
            self._generator = torch.Generator(device=self.device)
        return self._generator

    def _set_generators(self, model):
        """Seeds the loop's generator for this step, ``(seed, step_count)``,
        and gives it to every module of ``model`` that draws noise (one with
        a ``generator`` attribute: dropout, attention dropout, the VAE's
        posterior sample). Seeding one generator is the same as making a new
        one a step, and a captured step reads its seed at each replay."""
        seed = int(np.random.SeedSequence([self.seed, self.step_count]).generate_state(1)[0])
        generator = self._step_generator()
        generator.manual_seed(seed)
        for module in model.modules():
            if hasattr(module, 'generator'):
                module.generator = generator

    def _batch(self, features):
        """A batch's numeric values on the device (a collated numpy batch is
        moved, a device batch kept), with ``global_step``, the step count as
        a device int32 scalar (``training.py:297``) that a loss may schedule
        on (the VAE's KL annealing); a step replaces it by its scalar row's."""
        batch = device_features(features, self.device)
        batch['global_step'] = torch.full((), self.step_count, dtype=torch.int32,
                                          device=self.device)
        return batch

    def _upload(self, rows):
        """Per-step scalar rows as one float64 tensor on the device, copied
        from pinned memory without a host sync."""
        host = torch.tensor(rows, dtype=torch.float64)
        if self.device.type == 'cuda':
            return host.pin_memory().to(self.device, non_blocking=True)
        return host

    def _step_kind(self, items, force_apply):
        """What the next train step does with its gradient, from the open
        accumulation cycle: ``'apply'`` (no accumulation), ``'accum'`` (add
        it to the cycle) or ``'close'`` (add it and apply the cycle's mean);
        and the inverse item count of a closing cycle."""
        if self.grad_accum_steps <= 1:
            return 'apply', 1.0 / float(items)
        if self._micro_count + 1 < self.grad_accum_steps and not force_apply:
            return 'accum', 0.0
        return 'close', 1.0 / float(self._acc_items + items)

    def _adam_count(self):
        """The Adam ``count`` of the optimiser chain (0 without Adam)."""
        for transform, st in zip(self.optimizer.chain, self.opt_state):
            if transform == 'adam':
                return st['count']
        return 0

    def _scalars(self, lr, inv_items, count=None, step=None):
        """A row of :data:`SCALARS`: Adam's corrections at ``count + 1``
        (the count after the step applies) and ``global_step`` ``step``,
        by default the loop's own."""
        count = self._adam_count() if count is None else count
        step = self.step_count if step is None else step
        bc1, bc2 = self.optimizer.corrections(count + 1)
        return [float(lr), bc1, bc2, inv_items, float(step)]

    def _advance(self, kind, items):
        """The host's record of a step that ran: the Adam count, the
        accumulation cycle, the step count."""
        if kind == 'accum':
            self._micro_count += 1
            self._acc_items += items
            self.last_step_applied = False
        else:
            for transform, st in zip(self.optimizer.chain, self.opt_state):
                if transform == 'adam':
                    st['count'] += 1
            self._micro_count = self._acc_items = 0
            self.last_step_applied = True
        self.step_count += 1

    def _train_body(self, batch, sc, kind, items):
        """One train step on a device batch with its scalars ``sc`` (a
        :data:`SCALARS` row on the device): forward with the auxiliary
        losses, the gradient, and the accumulation or the optimiser and EMA.
        Device work only."""
        batch = dict(batch)
        batch['global_step'] = sc[4].to(torch.int32)
        self.model.train()
        with mnn.collect_aux_losses():
            loss, outputs = self.model(batch)
            loss = loss + mnn.collected_aux_loss()
        params = list(self.params.values())
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        step_grads = grads
        with torch.no_grad():
            if kind == 'apply':
                self._apply(grads, sc)
            else:
                if self._acc_grads is None:
                    self._acc_grads = [torch.zeros_like(p, dtype=torch.float32) for p in params]
                if kind == 'accum':
                    torch._foreach_add_(self._acc_grads, grads, alpha=float(items))
                else:
                    # (acc + n·g) / items of the cycle (training.py:358).
                    grads = torch._foreach_add(self._acc_grads, grads, alpha=float(items))
                    torch._foreach_mul_(grads, sc[3].float())
                    self._apply(grads, sc)
                    torch._foreach_zero_(self._acc_grads)
        return loss.detach(), {k: v.detach() for k, v in outputs.items()}, step_grads

    def train_step(self, features, lr, force_apply=False):
        """One training step on a collated batch (numpy, or already on the
        device). Returns ``(loss, outputs)`` as device tensors, detached; no
        host sync. Auxiliary losses that layers register (the
        mixture-of-experts balance term) join the loss that is optimised and
        returned (``training.py:41``).

        With ``grad_accum_steps = N > 1`` only every N-th call applies the
        optimiser and the EMA, to the item-weighted mean of the cycle's
        gradients; ``force_apply`` closes a shorter cycle (the epoch's last
        batch). :attr:`last_step_applied` says which kind of call this was."""
        batch = self._batch(features)
        items = batch_items(batch)
        kind, inv_items = self._step_kind(items, force_apply)
        sc = self._upload(self._scalars(lr, inv_items))
        self._set_generators(self.model)
        for p in self.params.values():
            p.grad = None
        loss, outputs, grads = self._train_body(batch, sc, kind, items)
        # Each parameter's .grad is this step's gradient, as a backward()
        # leaves it (a captured step keeps its gradients inside the graph).
        for p, g in zip(self.params.values(), grads):
            p.grad = g
        self._advance(kind, items)
        return loss, outputs

    def _apply(self, grads, sc):
        """The optimiser and EMA on ``grads``, and with ``log_norms`` the
        three norms of this applied step into the ``train`` metrics."""
        lr = sc[0].float()
        grads, updates = apply_updates(self.optimizer, self.ema_decay, self.params,
                                       self.opt_state, self.ema_params, lr, grads,
                                       corrections=(sc[1].float(), sc[2].float()))
        if self.log_norms:
            self.model.metrics.accumulate(
                'train', grad_norm=global_norm(grads), param_norm=global_norm(self.params.values()),
                update_norm=lr * global_norm(updates))

    def _model_for(self, use_ema):
        if use_ema:
            if self.ema_params is None:
                raise ValueError('use_ema=True but this loop tracks no EMA parameters '
                                 '(construct with ema_decay > 0)')
            return self.ema_model
        return self.model

    def _eval_body(self, model, batch, sc):
        batch = dict(batch)
        batch['global_step'] = sc[4].to(torch.int32)
        model.eval()
        with torch.no_grad():
            loss, outputs = model(batch)
        return loss, outputs

    def eval_step(self, features, use_ema=False):
        """Loss and outputs without a gradient (dropout off; the loss alone,
        without auxiliary terms), ``global_step`` in the batch as in
        training (``training.py:693``)."""
        model = self._model_for(use_ema)
        self._set_generators(model)
        sc = self._upload(self._scalars(0.0, 0.0))
        return self._eval_body(model, self._batch(features), sc)

    def predict_step(self, features, use_ema=False):
        """Outputs without a gradient (dropout off)."""
        model = self._model_for(use_ema)
        model.eval()
        with torch.no_grad():
            return model.predict(device_features(features, self.device))

    # ----------------------------------------------------------- chains

    def chain_apply_schedule(self, chain_len, batch, force_apply_last=False):
        """The apply schedule of the next ``chain_len`` steps of ``batch``
        items each, from the open accumulation cycle, without changing any
        state (``training.py:513``): ``(apply_flags, inv_items)``."""
        if self.grad_accum_steps <= 1:
            return [True] * chain_len, [1.0 / float(batch)] * chain_len
        flags, invs = [], []
        micro, items = self._micro_count, self._acc_items
        for i in range(chain_len):
            micro += 1
            items += batch
            apply = micro >= self.grad_accum_steps or (force_apply_last and i == chain_len - 1)
            flags.append(bool(apply))
            invs.append(1.0 / float(items) if apply else 0.0)
            if apply:
                micro, items = 0, 0
        return flags, invs

    def train_chain(self, cache, idx_mat, lr_values, post=None, bucket=True,
                    force_apply_last=False, lengths=None):
        """``len(idx_mat)`` consecutive train steps over a
        :class:`~morgana_tpu_torch.data.device_cache.DeviceCorpusCache`
        (``--steps_per_dispatch``; ``training.py:535``), each row of
        ``idx_mat`` a batch's dataset indices, all of one shape signature
        (``cache.batch_signature``), ``lr_values`` a step's learning rate
        each. Per-step numerics are the per-batch loop's: each step's
        learning rate, ``(seed, n)`` generator, ``global_step``, EMA, metric
        partials and accumulation schedule (the last step closes the cycle
        with ``force_apply_last``).

        On the CPU the chain is a plain loop of :meth:`train_step` over
        cache-assembled batches. On the GPU each step is a replay of a CUDA
        graph captured once per shape signature and step kind (an
        accumulating step and an applying one are two graphs), into one
        memory pool shared by every graph of the loop; the host uploads the
        chain's index rows and scalar rows once and replays. A signature's
        first step runs uncaptured (the warm-up that a capture needs), its
        second is captured. Returns ``(losses, staged)``: the ``(n,)`` loss
        vector on the device, and the stacked metric partials for
        ``Handler.apply_staged(staged, steps=n)`` (None on the CPU, where the
        steps accumulated their metrics themselves)."""
        idx_mat = np.asarray(idx_mat, np.int64)
        n, batch = idx_mat.shape
        if lengths is None:
            lengths = cache.padded_lengths(idx_mat.reshape(-1), bucket=bucket)
        flags, invs = self.chain_apply_schedule(n, batch, force_apply_last=force_apply_last)
        if self.device.type != 'cuda':
            losses = []
            for k, idxs in enumerate(idx_mat):
                features = cache.assemble(idxs, post=post, lengths=lengths)
                loss, _ = self.train_step(features, lr_values[k],
                                          force_apply=force_apply_last and k == n - 1)
                losses.append(loss)
            return torch.stack(losses), None
        kinds, rows = [], []
        count = self._adam_count()
        for k, (applied, inv) in enumerate(zip(flags, invs)):
            kinds.append('accum' if not applied else
                         'close' if self.grad_accum_steps > 1 else 'apply')
            rows.append(self._scalars(lr_values[k], inv, count, self.step_count + k))
            count += applied
        sig = ('train', id(cache), id(post), batch, tuple(sorted(lengths.items())))
        return self._graph_chain(sig, cache.scan_assemble(lengths, post=post), idx_mat, rows,
                                 kinds, self.model)

    def eval_chain(self, cache, idx_mat, post=None, bucket=True, use_ema=False, lengths=None):
        """``len(idx_mat)`` consecutive eval steps over a device-resident
        corpus (``training.py:653``), as :meth:`train_chain`: a plain loop of
        :meth:`eval_step` on the CPU, graph replays on the GPU. Returns
        ``(losses, staged)``."""
        idx_mat = np.asarray(idx_mat, np.int64)
        n, batch = idx_mat.shape
        if lengths is None:
            lengths = cache.padded_lengths(idx_mat.reshape(-1), bucket=bucket)
        if self.device.type != 'cuda':
            losses = [self.eval_step(cache.assemble(idxs, post=post, lengths=lengths),
                                     use_ema=use_ema)[0] for idxs in idx_mat]
            return torch.stack(losses), None
        model = self._model_for(use_ema)
        rows = [self._scalars(0.0, 0.0)] * n
        sig = ('eval', id(cache), id(post), batch, use_ema, tuple(sorted(lengths.items())))
        return self._graph_chain(sig, cache.scan_assemble(lengths, post=post), idx_mat, rows,
                                 ['eval'] * n, model)

    def _graph_chain(self, sig, assemble, idx_mat, rows, kinds, model):
        """Runs a chain's steps as CUDA graph replays (see
        :meth:`train_chain`)."""
        graphs = self._graphs
        if graphs is None:
            graphs = self._graphs = _ChainGraphs(self.device)
        n, batch = idx_mat.shape
        graphs.upload(idx_mat, rows)
        used = []
        for k, kind in enumerate(kinds):
            step = graphs.steps.get((sig, kind))
            self._set_generators(model)
            if step is None:
                step = graphs.steps[sig, kind] = _ChainStep(kind)
                graphs.run_eager(step, lambda s=step: self._chain_body(s, graphs, assemble, model,
                                                                       batch))
            elif step.graph is None:
                graphs.capture(step, lambda s=step: self._chain_body(s, graphs, assemble, model,
                                                                     batch),
                               self._step_generator())
                step.graph.replay()
            else:
                step.graph.replay()
            used.append(step)
            if kind != 'eval':
                self._advance(kind, batch)
        losses = graphs.losses[:n].clone()
        copies = {id(step): step.rows(n) for step in used}
        staged = [copies[id(step)] for step in used]
        return losses, staged

    def _chain_body(self, step, graphs, assemble, model, batch):
        """A chain step's device work: its index row and scalar row read at
        the device counter, the batch assembled, the step, its loss and
        metric partials written at the counter's row, the counter advanced."""
        counter = graphs.counter
        idxs = torch.index_select(graphs.index_rows(batch), 0, counter).view(batch)
        sc = torch.index_select(graphs.scalars, 0, counter).view(len(SCALARS))
        metrics = model.metrics
        since = len(metrics._pending)
        if step.kind == 'eval':
            loss, _ = self._eval_body(model, assemble(idxs), sc)
        else:
            loss, _, _ = self._train_body(assemble(idxs), sc, step.kind, batch)
        step.write(metrics.staged(since), counter, graphs.rows)
        graphs.losses.index_copy_(0, counter, loss.reshape(1).float())
        counter.add_(1)


class _ChainStep(object):
    """One captured step of a chain: its graph (None before its capture),
    the structure of the metric partials it stages and the stacked buffers
    it writes their tensors into, a row a step of the chain."""

    def __init__(self, kind):
        self.kind = kind
        self.graph = None
        self.names = []
        self.spec = None
        self.leaves = []
        self.buffers = []

    def write(self, staged, counter, rows):
        leaves, spec = tree_flatten([p for _, _, p in staged])
        if self.spec is None:
            self.names, self.spec, self.leaves = [(c, n) for c, n, _ in staged], spec, leaves
            self.buffers = [torch.zeros((rows,) + tuple(leaf.shape), dtype=leaf.dtype,
                                        device=leaf.device)
                            if isinstance(leaf, torch.Tensor) else None for leaf in leaves]
        for buffer, leaf in zip(self.buffers, leaves):
            if buffer is not None:
                buffer.index_copy_(0, counter, leaf.detach().reshape((1,) + tuple(leaf.shape)))

    def rows(self, n):
        """The staged partials of this step's rows of the chain so far, as
        ``[(collection, name, partials)]`` with each tensor a copy of the
        buffer's first ``n`` rows."""
        if self.spec is None:
            return []
        leaves = [leaf if buffer is None else buffer[:n].clone()
                  for buffer, leaf in zip(self.buffers, self.leaves)]
        return [(c, name, p) for (c, name), p in zip(self.names, tree_unflatten(leaves, self.spec))]


class _ChainGraphs(object):
    """The static buffers every captured step of a loop reads and writes,
    the capture stream and the shared memory pool.

    ``ints`` holds the counter (element 0) and a chain's index rows after
    it; ``scalars`` the chain's :data:`SCALARS` rows; ``losses`` a loss a
    step. A chain uploads ``ints`` (the counter reset to 0 with the rows)
    and ``scalars`` once; each step reads its rows at the counter and
    advances it. The buffers hold the longest chain and the widest batch
    seen so far: a longer or wider chain makes them anew, and the steps
    captured against the old ones are captured again."""

    def __init__(self, device):
        self.device = device
        self.rows = self.max_batch = 0
        self.steps = {}
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.captures = 0
        self.capture_seconds = 0.0

    def _reserve(self, n, batch):
        if n <= self.rows and batch <= self.max_batch:
            return
        self.rows, self.max_batch = max(self.rows, n), max(self.max_batch, batch)
        self.ints = torch.zeros(1 + self.rows * self.max_batch, dtype=torch.int64,
                                device=self.device)
        self.counter = self.ints[:1]
        self.scalars = torch.zeros((self.rows, len(SCALARS)), dtype=torch.float64,
                                   device=self.device)
        self.losses = torch.zeros(self.rows, dtype=torch.float32, device=self.device)
        self.steps = {}

    def index_rows(self, batch):
        return self.ints[1:1 + self.rows * batch].view(self.rows, batch)

    def upload(self, idx_mat, rows):
        n, batch = idx_mat.shape
        self._reserve(n, batch)
        ints = torch.from_numpy(np.concatenate([[0], idx_mat.reshape(-1)]).astype(np.int64))
        self.ints[:ints.numel()].copy_(ints.pin_memory(), non_blocking=True)
        scalars = torch.tensor(rows, dtype=torch.float64)
        self.scalars[:n].copy_(scalars.pin_memory(), non_blocking=True)

    def run_eager(self, step, body):
        """A step run uncaptured, on the capture stream: the warm-up before a
        capture (its libraries' handles and workspaces made for that
        stream), and a real step of the chain."""
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            body()
        current.wait_stream(self.stream)

    def capture(self, step, body, generator):
        """Captures ``body`` into ``step.graph`` (into the shared pool, the
        loop's generator registered so that each replay reads its seed).
        The capture runs nothing."""
        import time

        if not hasattr(torch.cuda.CUDAGraph, 'register_generator_state'):
            raise RuntimeError('--steps_per_dispatch on the GPU needs '
                               'torch.cuda.CUDAGraph.register_generator_state (PyTorch 2.5 or '
                               'newer) for the step generator')
        start = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(generator)
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                              capture_error_mode='thread_local'):
            body()
        step.graph = graph
        self.captures += 1
        self.capture_seconds += time.perf_counter() - start

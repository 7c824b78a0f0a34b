"""Learning-rate schedules (the port's own copy of
``morgana_tpu/lr_schedules.py``, which is pure Python).

Schedules are self-contained objects that *produce a scalar lr*, which the
trainer sets on the optimiser before each step.

The split between ``EPOCH_LR_SCHEDULES`` and ``BATCH_LR_SCHEDULES`` drives
when ``.step()`` is called (as in ``morgana/experiment_builder.py:477-478,
559-560``), and ``'plateau'`` is stepped with the validation loss
(``morgana/experiment_builder.py:550-551``).
"""
import math
from functools import partial

__all__ = [
    'SUPPORTED', 'EPOCH_LR_SCHEDULES', 'BATCH_LR_SCHEDULES', 'init_lr_schedule',
    'DummyLR', 'LambdaLR', 'StepLR', 'MultiStepLR', 'ExponentialLR',
    'CosineAnnealingLR', 'CosineAnnealingWarmRestarts', 'CyclicLR',
    'ReduceLROnPlateau', 'NoamLR', 'CyclicNoamLR',
]

EPOCH_LR_SCHEDULES = ['constant', 'lambda', 'step', 'multi_step', 'exponential',
                      'cosine_annealing', 'cosine_annealing_warm_restarts']
BATCH_LR_SCHEDULES = ['cyclic', 'noam', 'cyclic_noam']


class _LRSchedule(object):
    r"""Base class. ``last_epoch`` counts completed ``step()`` calls (torch
    semantics: the constructor performs the initial step to index 0)."""

    def __init__(self, base_lr):
        self.base_lr = float(base_lr)
        self.last_epoch = 0
        self.lr = self.compute(self.last_epoch)

    def compute(self, last_epoch):
        return self.base_lr

    def step(self, metrics=None):
        self.last_epoch += 1
        self.lr = self.compute(self.last_epoch)
        return self.lr

    def get_lr(self):
        return [self.lr]

    def state_dict(self):
        # Callables (e.g. LambdaLR's lr_lambda) are construction-time config,
        # not state — excluded so the dict stays picklable.
        return {k: v for k, v in vars(self).items() if not callable(v)}

    def load_state_dict(self, state):
        """Restores PROGRESS state only: ``base_lr`` is construction-time
        config, so a resume launched with a different ``--learning_rate``
        keeps the new rate. The saved lr is rescaled by the base-lr ratio —
        for deterministic schedules this equals ``compute(last_epoch)`` at
        the new base, and it carries plateau-style multiplicative reductions
        across the base change."""
        state = dict(state)
        old_base = float(state.pop('base_lr', self.base_lr))
        saved_lr = state.pop('lr', None)
        vars(self).update(state)
        if saved_lr is not None:
            self.lr = float(saved_lr) * (self.base_lr / old_base if old_base
                                         else 1.0)


class DummyLR(_LRSchedule):
    r"""Constant learning rate."""


class LambdaLR(_LRSchedule):
    def __init__(self, base_lr, lr_lambda=None):
        self.lr_lambda = lr_lambda if lr_lambda is not None else (lambda epoch: 1.0)
        super().__init__(base_lr)

    def compute(self, last_epoch):
        return self.base_lr * self.lr_lambda(last_epoch)


class StepLR(_LRSchedule):
    def __init__(self, base_lr, step_size=30, gamma=0.1):
        self.step_size = step_size
        self.gamma = gamma
        super().__init__(base_lr)

    def compute(self, last_epoch):
        return self.base_lr * self.gamma ** (last_epoch // self.step_size)


class MultiStepLR(_LRSchedule):
    def __init__(self, base_lr, milestones=(30, 80), gamma=0.1):
        self.milestones = sorted(milestones)
        self.gamma = gamma
        super().__init__(base_lr)

    def compute(self, last_epoch):
        n = sum(1 for m in self.milestones if m <= last_epoch)
        return self.base_lr * self.gamma ** n


class ExponentialLR(_LRSchedule):
    def __init__(self, base_lr, gamma=0.95):
        self.gamma = gamma
        super().__init__(base_lr)

    def compute(self, last_epoch):
        return self.base_lr * self.gamma ** last_epoch


class CosineAnnealingLR(_LRSchedule):
    def __init__(self, base_lr, T_max=50, eta_min=0.):
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(base_lr)

    def compute(self, last_epoch):
        return self.eta_min + (self.base_lr - self.eta_min) * \
            (1 + math.cos(math.pi * last_epoch / self.T_max)) / 2


class CosineAnnealingWarmRestarts(_LRSchedule):
    def __init__(self, base_lr, T_0=10, T_mult=1, eta_min=0.):
        self.T_0 = T_0
        self.T_mult = T_mult
        self.eta_min = eta_min
        super().__init__(base_lr)

    def compute(self, last_epoch):
        t_cur, t_i = last_epoch, self.T_0
        while t_cur >= t_i:
            t_cur -= t_i
            t_i *= self.T_mult
        return self.eta_min + (self.base_lr - self.eta_min) * \
            (1 + math.cos(math.pi * t_cur / t_i)) / 2


class CyclicLR(_LRSchedule):
    r"""Triangular cyclical lr (stepped per batch)."""

    def __init__(self, base_lr, max_lr=None, step_size_up=2000, step_size_down=None,
                 mode='triangular', gamma=1.0):
        self.max_lr = max_lr if max_lr is not None else base_lr * 10
        self.step_size_up = step_size_up
        self.step_size_down = step_size_down if step_size_down is not None else step_size_up
        self.mode = mode
        self.gamma = gamma
        super().__init__(base_lr)

    def compute(self, last_epoch):
        cycle_len = self.step_size_up + self.step_size_down
        cycle = last_epoch // cycle_len
        pos = last_epoch - cycle * cycle_len
        if pos < self.step_size_up:
            frac = pos / self.step_size_up
        else:
            frac = 1.0 - (pos - self.step_size_up) / self.step_size_down
        amplitude = self.max_lr - self.base_lr
        if self.mode == 'triangular2':
            amplitude = amplitude / (2 ** cycle)
        elif self.mode == 'exp_range':
            amplitude = amplitude * (self.gamma ** last_epoch)
        return self.base_lr + amplitude * frac


class ReduceLROnPlateau(_LRSchedule):
    r"""Reduce lr when a monitored metric stops improving. ``step`` must be
    called with the metric (the builder passes the validation loss,
    ``morgana/experiment_builder.py:550-551``)."""

    def __init__(self, base_lr, mode='min', factor=0.1, patience=10,
                 threshold=1e-4, threshold_mode='rel', cooldown=0, min_lr=0.):
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.best = math.inf if mode == 'min' else -math.inf
        self.num_bad_epochs = 0
        self.cooldown_counter = 0
        super().__init__(base_lr)

    def _is_better(self, current):
        if self.mode == 'min':
            if self.threshold_mode == 'rel':
                return current < self.best * (1 - self.threshold)
            return current < self.best - self.threshold
        if self.threshold_mode == 'rel':
            return current > self.best * (1 + self.threshold)
        return current > self.best + self.threshold

    def step(self, metrics=None):
        self.last_epoch += 1
        if metrics is None:
            return self.lr
        current = float(metrics)
        if self._is_better(current):
            self.best = current
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1

        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0

        if self.num_bad_epochs > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        return self.lr


class NoamLR(_LRSchedule):
    r"""Linear warmup then inverse-sqrt decay (``morgana/lr_schedules.py:45-90``).

    scale = warmup^0.5 * min(step^-0.5, step * warmup^-1.5)
    """

    def __init__(self, base_lr, warmup_steps=4000):
        self.warmup_steps = warmup_steps
        super().__init__(base_lr)

    def scale(self, step):
        return self.warmup_steps ** 0.5 * min(step ** (-0.5), step * self.warmup_steps ** (-1.5))

    def compute(self, last_epoch):
        return self.base_lr * self.scale(max(1, last_epoch))


class CyclicNoamLR(NoamLR):
    r"""Noam pattern repeating every ``cycle_steps`` batches
    (``morgana/lr_schedules.py:93-145``)."""

    def __init__(self, base_lr, warmup_steps=4000, cycle_trigger=0.2, cycle_steps=None):
        self.warmup_steps = warmup_steps
        if cycle_steps is None:
            self.cycle_steps = int((cycle_trigger / warmup_steps ** 0.5) ** -2)
        else:
            self.cycle_steps = cycle_steps
        super().__init__(base_lr, warmup_steps=warmup_steps)

    def compute(self, last_epoch):
        return self.base_lr * self.scale(max(1, last_epoch % self.cycle_steps))


SUPPORTED = {
    'constant': DummyLR,
    'lambda': LambdaLR,
    'step': StepLR,
    'multi_step': MultiStepLR,
    'exponential': ExponentialLR,
    'cosine_annealing': CosineAnnealingLR,
    'cosine_annealing_warm_restarts': CosineAnnealingWarmRestarts,
    'cyclic': CyclicLR,
    'plateau': ReduceLROnPlateau,
    'noam': NoamLR,
    'cyclic_noam': CyclicNoamLR,
}


def init_lr_schedule(lr_name, **kwargs):
    r"""Partially initialises a schedule; the base lr completes initialisation
    (reference API shape: ``morgana/lr_schedules.py:28-30``)."""
    return partial(SUPPORTED[lr_name], **kwargs)

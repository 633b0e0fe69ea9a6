"""Train state of the PyTorch port: the four parameter groups, the two
discriminators' BatchNorm statistics, the four Adam states, the step and
the noise key: the whole of what a checkpoint saves.

Counterpart of ``kccotgan_tpu/train/state.py``.  Parameters and
statistics are dicts of ``state_dict`` keys (the flax paths joined by
dots) to tensors.  ``rng`` is a 63-bit integer key, split like a JAX key
(``split_key``, ``fold_in``): a step draws its noise from a fresh
``torch.Generator`` seeded from one half and carries the other on, so a
draw depends on the key alone and a resumed run replays its noise.  With
dropout on, a step takes a further split for its masks (``dropout_keys``),
so the dropout-free key sequence is the same with or without it in the
code.  The two packages' random streams differ, so the port's keys are
its own.

The state's tensors have one layout, which the graphed step's buffers, the
mesh's broadcast and the card checks read: ``state_tensors`` lists them,
``state_with_tensors`` puts a list back.  A checkpoint nests the same
trees by ``GROUPS`` and ``STATS`` (``ckpt/checkpoint.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..weights import init_discriminator_params, init_generator_params
from .keras_adam import KerasAdam, KerasAdamState
from .schedule import warmup_staircase_exponential_decay

__all__ = [
    "GROUPS", "STATS", "TrainState", "create_train_state", "dropout_keys", "fold_in", "key_from_seed",
    "make_optimizers", "split_key", "state_tensors", "state_with_tensors",
]

GROUPS = ("enc", "dec", "h", "m")  # the parameter groups, each with its Adam
STATS = ("h_stats", "m_stats")  # the discriminators' BatchNorm statistics

_M64 = (1 << 64) - 1
_KEY_BITS = (1 << 63) - 1  # a key fits an int64 and any torch.Generator seed


def _mix(x: int) -> int:
    """splitmix64: a bijection of 64-bit integers that scatters each bit."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def key_from_seed(seed: int) -> int:
    """The key a run with this seed starts from."""
    return _mix(seed & _M64) & _KEY_BITS


def split_key(key: int) -> tuple[int, int]:
    """``(next key, seed of this draw)``, both derived from ``key``."""
    return _mix(key ^ 1) & _KEY_BITS, _mix(key ^ 2) & _KEY_BITS


def fold_in(key: int, data: int) -> int:
    """A new key from ``key`` and an integer, as ``jax.random.fold_in``."""
    return _mix(key ^ _mix(data & _M64)) & _KEY_BITS


def dropout_keys(key: int) -> tuple[int, tuple[int, int], tuple[int, int]]:
    """``(next key, disc phase's seeds, gen phase's seeds)``: the split a
    step takes for its dropout masks, each phase's pair seeding its
    encoder's masks and its decoder's."""
    key, d = split_key(key)
    d_disc, d_gen = split_key(d)
    return key, split_key(d_disc), split_key(d_gen)


@dataclass
class TrainState:
    step: int
    rng: int  # the noise key (module docstring)
    enc_params: dict
    dec_params: dict
    h_params: dict
    m_params: dict
    h_stats: dict  # BatchNorm running statistics (empty when norms are off)
    m_stats: dict
    enc_opt: KerasAdamState
    dec_opt: KerasAdamState
    h_opt: KerasAdamState
    m_opt: KerasAdamState


def _trees(state: TrainState) -> dict:
    """The state's dicts of tensors by name, in the layout's order: each
    group's parameters, the statistics, then each group's Adam moments."""
    trees = {f"{g}_params": getattr(state, f"{g}_params") for g in GROUPS}
    trees.update((name, getattr(state, name)) for name in STATS)
    for g in GROUPS:
        opt = getattr(state, f"{g}_opt")
        trees.update({f"{g}_opt.mu": opt.mu, f"{g}_opt.nu": opt.nu})
    return trees


def state_tensors(state: TrainState) -> dict:
    """Every tensor of ``state`` by its path (``"enc_params/<key>"``,
    ``"h_stats/<key>"``, ``"enc_opt.mu/<key>"``), in the layout's order:
    the parameters of each group of ``GROUPS``, the statistics ``STATS``,
    then each group's Adam moments mu and nu."""
    return {f"{name}/{k}": v for name, tree in _trees(state).items() for k, v in tree.items()}


def state_with_tensors(state: TrainState, tensors, *, step: int | None = None, rng: int | None = None,
                       counts=None) -> TrainState:
    """``state`` with ``tensors`` (in ``state_tensors`` order) in place of
    its own, and ``step``, ``rng`` and the Adams' ``counts`` (in ``GROUPS``
    order) in place of its own where given."""
    it = iter(tensors)
    trees = {name: {k: next(it) for k in tree} for name, tree in _trees(state).items()}
    if counts is None:
        counts = [getattr(state, f"{g}_opt").count for g in GROUPS]
    return TrainState(
        step=state.step if step is None else step,
        rng=state.rng if rng is None else rng,
        **{f"{g}_params": trees[f"{g}_params"] for g in GROUPS},
        **{name: trees[name] for name in STATS},
        **{f"{g}_opt": KerasAdamState(count=count, mu=trees[f"{g}_opt.mu"], nu=trees[f"{g}_opt.nu"])
           for g, count in zip(GROUPS, counts)},
    )


def make_optimizers(cfg) -> dict:
    """Four Keras-3-exact Adams on the warmup + staircase-decay schedule.
    The first ``apply_gradients`` of each shared Keras optimizer gets
    offset 0 and the second 1: h then m, encoder then decoder."""

    def adam(offset: int) -> KerasAdam:
        sched = warmup_staircase_exponential_decay(
            cfg.lr, cfg.warmup_steps, cfg.decay_steps, cfg.decay_rate
        )
        return KerasAdam(
            sched, b1=cfg.beta1, b2=cfg.beta2, eps=cfg.adam_eps,
            double_step=cfg.keras_double_step_quirk, offset=offset,
        )

    return dict(enc=adam(0), dec=adam(1), h=adam(0), m=adam(1))


def create_train_state(cfg, generator: torch.Generator | None = None, device="cuda") -> TrainState:
    """A fresh state on ``device``, every parameter drawn from
    ``generator`` (seeded with ``cfg.seed`` if none is given) with flax's
    distributions: glorot-uniform kernels, orthogonal recurrent kernels,
    unit forget biases, norms at scale 1 and bias 0, running means 0 and
    variances 1.  The noise key comes from ``cfg.seed``."""
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    gen = init_generator_params(cfg, generator)
    disc = init_discriminator_params(cfg, generator)

    def to_dev(tree):
        return {k: v.to(device) for k, v in tree.items()}

    enc, dec = to_dev(gen["encoder"]), to_dev(gen["decoder"])
    h, m = to_dev(disc["h"]), to_dev(disc["m"])
    opts = make_optimizers(cfg)
    return TrainState(
        step=0,
        rng=key_from_seed(cfg.seed),
        enc_params=enc,
        dec_params=dec,
        h_params=h,
        m_params=m,
        h_stats=to_dev(disc["h_stats"]),
        m_stats=to_dev(disc["m_stats"]),
        enc_opt=opts["enc"].init(enc),
        dec_opt=opts["dec"].init(dec),
        h_opt=opts["h"].init(h),
        m_opt=opts["m"].init(m),
    )

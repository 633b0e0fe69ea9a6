"""GAN training step of the PyTorch port: discriminator phase, then
generator phase.

Counterpart of ``kccotgan_tpu/train/steps.py``:

* the context is encoded once (``share_context_encoding``, off with
  dropout): the discriminator phase reads the pyramid detached, and the
  generator phase backpropagates through the same pyramid into the
  encoder, which is the port's form of the JAX step's ``jax.vjp``; the
  real video is then smoothed once a step too.  Otherwise each phase
  encodes the context, under its own dropout masks, and smooths the real
  video itself;
* discriminator phase: noise z1, the decoder in teacher forcing (no graph:
  none of its inputs needs a gradient), Gaussian smoothing of the real
  and the fake video (``cfg.kernel``, at ``sigma``), the four
  discriminator passes h(fake), h(real), m(real), m(fake) with the
  BatchNorm statistics chained in that order, the mixed Sinkhorn
  divergence of the smoothed videos and pM on ``m_real``; ``-loss + pM``
  is minimized over h and m by two Keras-exact Adams.  Under
  ``cfg.fused_discriminators`` the four passes are one
  (``fused_discriminators``): ``torch.func.vmap`` of one discriminator
  over parameters stacked ``[h, h, m, m]`` and videos ``[fake, real,
  real, fake]``, the statistics chain rebuilt from the four instances'
  updates as JAX rebuilds it;
* generator phase: new noise z2 against the updated discriminators,
  starting from the statistics the discriminator phase left; ``loss`` is
  minimized over the encoder and the decoder.

``sigma`` is ``cfg.init_sigma``, or under ``cfg.decaying_sigma``
``annealing_sigma(init_sigma, step + 1)``, computed on the host from the
integer step.

Recurrence engine, ``cfg.kernel_impl``: under ``'scan'`` (and ``'auto'``)
every ConvLSTM and LSTM recurrence runs its plain loop under autograd,
the counterpart of ``lax.scan``.  Under ``'pallas'`` each runs the fused
recurrence, as JAX's ``'pallas'`` does in its batch-major, unpacked
layout (``time_major=False, conv_packing='off'``): on the card the
ConvLSTM and LSTM forward kernels, and their backward kernels wherever
autograd needs a gradient.  The discriminator phase's decoder needs none
(its parameters, pyramid and noise carry no gradient), so it runs the
forward kernel alone.  Dropout keeps each engine: under ``'pallas'`` the
ConvLSTM kernels take the recurrent masks (their masked mode) and the
input masks change only the hoisted input convs (``models/layers.py``),
where JAX's ``'pallas'`` sends such a layer to ``lax.scan``.  The
Sinkhorn solves go through the fused kernels (``ot/cuda_sinkhorn.py``:
one forward and one backward launch a phase) unless
``cfg.sinkhorn_solver`` is ``'scan'``.

Meshes (``parallel/``) reach the step through three arguments of
``build_train_step``; without them the step is the one-device step, to
the bit: ``group`` (JAX's ``axis_name``, the per-shard mode: noise and
masks from keys folded with the rank, each rank's Sinkhorn and pM on its
shard, gradients, pM, the loss and the statistics averaged over the
group), ``encode`` / ``decode`` (JAX's hooks: the generator's forwards,
which the sequence-parallel step runs time-sharded) and ``placement``
(``Placement``: where the exact modes put the batch, the counterpart of
what GSPMD does in JAX's global-batch mode).
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch
from torch.func import functional_call

from ..config import check_trainable
from ..models.cuda_convlstm import convlstm_bwd, convlstm_fwd
from ..models.cuda_lstm import lstm_bwd, lstm_fwd
from ..models.layers import BatchNorm, bernoulli_source
from ..models.video import discriminator_modules, generator_modules
from ..ot import compute_sinkhorn_loss, martingale_regularization
from ..ot.cuda_sinkhorn import sinkhorn_bwd, sinkhorn_fwd
from ..parallel.comm import COUNTERS, all_reduce_sum_flat
from ..smoothing import annealing_sigma, apply_smoothing
from .graph import StepGraph
from .state import (
    GROUPS, TrainState, dropout_keys, fold_in, make_optimizers, split_key, state_tensors, state_with_tensors,
)

__all__ = ["GanModules", "Placement", "build_train_step", "fused_discriminators", "gan_forward", "replays_graph"]


class GanModules:
    """The four modules a config describes, on the meta device: they only
    describe the computation, every parameter comes from the state.  Their
    recurrences take the engine ``cfg.kernel_impl`` names; ``seq_axis``
    and ``bn_group`` as in ``models/video.py``."""

    def __init__(self, cfg, *, seq_axis=None, bn_group=None):
        with torch.device("meta"):
            self.encoder, self.decoder = generator_modules(cfg, seq_axis)
            self.disc_h, self.disc_m = discriminator_modules(cfg, bn_group)


class Placement:
    """Where a step's batch lives: on one device, every hook the
    identity.  ``parallel/sharding.py::MeshPlacement`` splits the batch
    over a mesh's ranks.

    * ``bn_group``: the group over whose ranks the batch's rows are
      split: the discriminators' BatchNorm statistics and the smoothing's
      normalizing maximum are the whole batch's;
    * ``rows``: how many ranks share the batch's rows, so that the noise
      is drawn for ``rows`` times the rank's batch;
    * ``noise(z)``: this rank's part of noise drawn for the whole batch;
    * ``masks(source)``: a mask source that draws each mask for the whole
      batch from ``source`` and hands back this rank's part;
    * ``loss_inputs(xs)``: the smoothed videos and the four feature
      stacks as the loss needs them (the whole batch's);
    * ``sum_grads(phase, grads)``: the whole batch's gradients of one
      phase (``'disc'`` or ``'gen'``) from this rank's parts;
    * ``graphable``: whether the step may replay a CUDA graph, its
      collectives captured with its kernels (``replays_graph``).  The
      identity placement says no: it is the eager form of the one-device
      step, which the graphed step is held against.
    """

    bn_group = None
    rows = 1
    graphable = False

    def noise(self, z):
        return z

    def masks(self, source):
        return source

    def loss_inputs(self, xs):
        return xs

    def sum_grads(self, phase, grads):
        return grads


def _smooth(cfg, video, sigma, group=None):
    return apply_smoothing(
        video, sigma, cfg.kernel,
        temporal_kernel=cfg.temporal_kernel_size, spatial_kernel=cfg.spatial_kernel_size, group=group,
    )


def fused_discriminators(mods, h_params, m_params, h_stats, m_stats, fake_s, real_s):
    """The four discriminator passes as one, JAX's ``jax.vmap(one)``:
    ``((h_fake, h_real, m_real, m_fake), h_stats, m_stats)``.

    Each instance normalizes by its own batch, as a separate call does;
    each starts from its discriminator's old statistics, so the chain of
    the sequential order is rebuilt as ``mu * first + second - mu * old``
    (each update is ``mu * old + (1 - mu) * batch``).  Under 'pallas'
    each LSTM layer launches its kernels once for the four instances
    (``LstmScan.vmap``); the convs and products become grouped and
    batched library calls."""
    def stack(h, m):
        return {k: torch.stack([h[k], h[k], m[k], m[k]]) for k in h}

    def one(params, stats, video):
        return functional_call(mods.disc_h, params, (video, stats))

    outs, new = torch.func.vmap(one)(
        stack(h_params, m_params), stack(h_stats, m_stats), torch.stack([fake_s, real_s, real_s, fake_s])
    )
    mu = BatchNorm.momentum
    h_stats = {k: mu * new[k][0] + new[k][1] - mu * old for k, old in h_stats.items()}
    m_stats = {k: mu * new[k][2] + new[k][3] - mu * old for k, old in m_stats.items()}
    return outs.unbind(0), h_stats, m_stats


def _encode(mods, params, video, masks):
    return functional_call(mods.encoder, params, (video,), {"training": True, "masks": masks})


def _decode(mods, params, pyramid, z, masks):
    return functional_call(mods.decoder, params, (pyramid, z), {"training": True, "masks": masks})


def gan_forward(mods, cfg, enc_params, dec_params, h_params, m_params, h_stats, m_stats, real_data, z,
                sigma, masks=None, pyramid=None, real_smoothed=None, encode=None, decode=None,
                loss_inputs=None):
    """One full forward pass: encode, decode (teacher forcing), smooth,
    discriminate.  Returns ``(loss, pm, h_stats, m_stats)``: the mixed
    Sinkhorn divergence of the smoothed videos, pM on ``m_real`` and the
    chained BatchNorm statistics.

    ``masks = (encoder's, decoder's)`` mask sources for the ConvLSTMs'
    dropout, needed when the config has dropout.  ``pyramid`` supplies
    the context encoding (``enc_params`` is then unused), and
    ``real_smoothed`` the smoothed real video, both computed once a step
    when the encoding is shared.  ``encode(params, video, masks) ->
    pyramid`` and ``decode(params, pyramid, z, masks) -> frames`` replace
    the generator's forwards (JAX's hooks), ``loss_inputs`` maps the
    smoothed videos and feature stacks before the loss
    (``Placement.loss_inputs``)."""
    enc_masks, dec_masks = masks if masks is not None else (None, None)
    if pyramid is None:
        pyramid = (encode or functools.partial(_encode, mods))(enc_params, real_data, enc_masks)
    fake_pred = (decode or functools.partial(_decode, mods))(dec_params, pyramid, z, dec_masks)
    fake = torch.cat([real_data[:, :, : cfg.int_time_steps], fake_pred], dim=2)
    group = mods.disc_h.bn_group  # the ranks the batch's rows are split over, in the exact modes
    real_s = real_smoothed if real_smoothed is not None else _smooth(cfg, real_data, sigma, group)
    fake_s = _smooth(cfg, fake, sigma, group)
    if cfg.fused_discriminators:
        (h_fake, h_real, m_real, m_fake), h_stats, m_stats = fused_discriminators(
            mods, h_params, m_params, h_stats, m_stats, fake_s, real_s)
    else:
        h_fake, h_stats = functional_call(mods.disc_h, h_params, (fake_s, h_stats))
        h_real, h_stats = functional_call(mods.disc_h, h_params, (real_s, h_stats))
        m_real, m_stats = functional_call(mods.disc_m, m_params, (real_s, m_stats))
        m_fake, m_stats = functional_call(mods.disc_m, m_params, (fake_s, m_stats))
    if loss_inputs is not None:
        real_s, fake_s, h_fake, m_real, h_real, m_fake = loss_inputs((real_s, fake_s, h_fake, m_real, h_real, m_fake))
    scaling = cfg.effective_scaling
    loss = compute_sinkhorn_loss(
        real_s, fake_s, scaling, h_fake, m_real, h_real, m_fake,
        video=True, epsilon=cfg.sinkhorn_eps, num_iters=cfg.sinkhorn_l,
        cost_method=cfg.cost_method, solver=cfg.sinkhorn_solver,
    )
    pm = martingale_regularization(m_real, cfg.reg_penalty, scaling)
    return loss, pm, h_stats, m_stats


def _leaves(params: dict) -> dict:
    return {k: v.detach().requires_grad_() for k, v in params.items()}


def _grads(loss, *groups):
    """Gradients of ``loss`` with respect to each dict of ``groups``."""
    flat = [v for g in groups for v in g.values()]
    grads = iter(torch.autograd.grad(loss, flat))
    return [{k: next(grads) for k in g} for g in groups]


def _pmean(group, *trees):
    """Each dict or tensor of ``trees`` averaged over ``group``: JAX's
    ``pmean``, in one all-reduce."""
    leaves = [v for t in trees for v in (t.values() if isinstance(t, dict) else (t,))]
    n = torch.distributed.get_world_size(group)
    means = iter(x / n for x in all_reduce_sum_flat(leaves, group))
    return [{k: next(means) for k in t} if isinstance(t, dict) else next(means) for t in trees]


# what the kernels' wrappers and the collectives count; a graph replay
# adds what its capture counted
_KERNEL_COUNTERS = tuple(
    (fn, name) for fn in (convlstm_fwd, convlstm_bwd, lstm_fwd, lstm_bwd) for name in ("calls", "launches")
) + ((convlstm_fwd, "gate_stacks"), (sinkhorn_fwd, "launches"), (sinkhorn_bwd, "launches"))
_COMM_COUNTERS = tuple((COUNTERS[op], name) for op in COUNTERS for name in ("calls", "bytes"))


def replays_graph(cfg, device, *, group=None, encode=None, decode=None, placement=None) -> bool:
    """Whether ``build_train_step``'s step with these arguments replays a
    CUDA graph: on the card, the one-device step or the exact mode on a
    data mesh over NCCL (``placement.graphable``), drawing no dropout
    masks and smoothing at the same sigma every step (or not at all).
    Eager: the per-shard mode (``group``), the sequence-parallel hooks
    (``encode`` / ``decode``) and every mesh with a seq axis, gloo, the
    identity ``Placement``, dropout, decaying smoothing, the CPU."""
    m = cfg.model
    return (
        torch.device(device).type == "cuda"
        and group is None and encode is None and decode is None
        and (placement is None or placement.graphable)
        and m.dropout <= 0.0 and m.rnn_dropout <= 0.0
        and (not cfg.decaying_sigma or cfg.kernel == "none")
    )


def build_train_step(cfg, *, device="cuda", group=None, encode=None, decode=None,
                     placement: Placement | None = None) -> Callable:
    """Returns ``train_step(state, real_data, generator=None, z=None,
    masks=None) -> (state, metrics)``.

    ``real_data`` is the film-strip batch ``[B, H, T, W, C]`` (context and
    future along axis 2) on ``device``.  ``z = (z1, z2)``, each
    ``[B, pred_time_steps, z_h, z_w, z_c]``, injects the two phases' noise;
    otherwise both are drawn with ``torch.randn`` on ``device`` from
    ``generator`` or, when none is given, from a generator seeded by a
    split of ``state.rng``, whose other half the new state carries.  With
    dropout, ``masks`` (a mask source, ``models.layers.bernoulli_source``)
    injects every mask of the step in the order they are drawn:
    discriminator phase's encoder, its decoder, then the generator
    phase's; otherwise each of the four draws from a generator seeded by
    ``dropout_keys`` of the state's key.
    ``metrics`` is ``{"sinkhorn_loss", "pm", "sigma"}`` as 0-d tensors
    (the generator phase's loss on the card, the discriminator phase's
    pM, and the host's sigma).
    ``cfg.kernel_impl`` picks the recurrences' engine (module
    docstring); ``cfg.sinkhorn_solver='scan'`` solves the Sinkhorn
    problems with the plain loop under autograd, the kernels' reference.
    The state passed in is left as it was.

    ``group``: the per-shard mode (module docstring), ``real_data`` this
    rank's rows; the drawn noise and masks come from the keys folded with
    the rank in ``group``.  ``placement``: the exact modes; ``z`` and the
    masks, drawn or injected, are then the whole batch's, of which the
    step keeps this rank's part.  ``encode`` / ``decode``: as in
    ``gan_forward``.

    On the card, the one-device step (no ``group``, ``placement``,
    ``encode`` or ``decode``) and the exact mode on a data mesh over NCCL
    (``MeshPlacement``), when they draw no dropout masks and smooth at
    one sigma every step (``replays_graph``), replay their device work
    from a CUDA graph (``StepGraph``), one for each signature of batch,
    noise and state: the first call of a signature runs eagerly and warms
    up (on a mesh it also sets up the communicators), the second
    captures.  The state goes in and out through the graph's buffers, the
    noise (on a mesh, the whole batch's) is copied in or drawn into its
    buffer as the eager step draws it, and each Adam's step size, which
    changes with its count, is written to the card before each replay;
    the state handed back is the caller's to keep.  The replay runs the
    eager step's kernels and collectives in their order; on a mesh every
    rank captures the same collectives in the same order at its second
    call, so the ranks' graphs agree.  A replay advances the kernels' and
    the collectives' counters (``parallel.comm.COUNTERS``) by what its
    capture issued.  Every other step runs eagerly.  The step's
    ``counts`` say how many calls ran eagerly (``eager``), captured a
    graph (``captures``) and replayed one (``replays``; a capturing call
    replays too).
    """
    check_trainable(cfg)
    place = placement or Placement()
    if group is not None and placement is not None:
        raise ValueError("build_train_step: the per-shard group and an exact placement exclude each other")
    mods = GanModules(cfg, bn_group=place.bn_group)
    opts = make_optimizers(cfg)
    m = cfg.model
    needs_dropout = m.dropout > 0.0 or m.rnn_dropout > 0.0
    share_ctx = cfg.share_context_encoding and not needs_dropout
    rank = torch.distributed.get_rank(group) if group is not None else None
    hooks = dict(encode=encode, decode=decode, loss_inputs=place.loss_inputs)

    def seeded(seed):
        return torch.Generator(device=device).manual_seed(seed if rank is None else fold_in(seed, rank))

    def phase_masks(rng, masks):
        """``(rng, (disc phase's mask sources, gen phase's))``."""
        if not needs_dropout:
            return rng, (None, None)
        if masks is not None:
            masks = place.masks(masks)
            return rng, ((masks, masks), (masks, masks))
        rng, *phases = dropout_keys(rng)
        return rng, tuple(tuple(place.masks(bernoulli_source(seeded(k))) for k in seeds) for seeds in phases)

    def noise_shape(real_data):
        return (real_data.shape[0] * place.rows, cfg.pred_time_steps, m.z_height, m.z_width, m.z_channels)

    def noise(rng, real_data, generator=None, z=None, out=(None, None)):
        """``(rng, z1, z2)``: ``z``, or both phases' noise drawn from
        ``generator`` or from a split of ``rng``, each into its ``out``."""
        if z is not None:
            return (rng, *z)
        if generator is None:
            rng, seed = split_key(rng)
            generator = seeded(seed)
        z1 = torch.randn(noise_shape(real_data), generator=generator, device=device, out=out[0])
        z2 = torch.randn(noise_shape(real_data), generator=generator, device=device, out=out[1])
        return rng, z1, z2

    def step_sigma(step):
        if cfg.decaying_sigma:
            return annealing_sigma(cfg.init_sigma, step + 1)  # the reference's steps count from 1
        return float(np.float32(cfg.init_sigma))

    def iterate(state, real_data, z1, z2, sigma, disc_masks=None, gen_masks=None, alphas=None):
        """The step's device work: ``(state with its tensors, step and
        counts advanced, gen_loss, pm)``.  ``alphas``: each Adam's step
        size by group, 0-d tensors on the card; without them each Adam
        computes its own on the host."""
        alpha = alphas or dict.fromkeys(GROUPS)
        z1, z2 = place.noise(z1), place.noise(z2)
        enc_p = _leaves(state.enc_params)
        if share_ctx:
            pyramid = (encode or functools.partial(_encode, mods))(enc_p, real_data, None)
            real_s = _smooth(cfg, real_data, sigma, place.bn_group)
        else:
            pyramid = real_s = None

        # ---------------- discriminator phase -----------------
        h_p, m_p = _leaves(state.h_params), _leaves(state.m_params)
        loss, pm, h_stats, m_stats = gan_forward(
            mods, cfg, state.enc_params, state.dec_params, h_p, m_p, state.h_stats, state.m_stats,
            real_data, z1, sigma, masks=disc_masks,
            pyramid=[p.detach() for p in pyramid] if pyramid is not None else None, real_smoothed=real_s,
            **hooks,
        )
        gh, gm = place.sum_grads("disc", _grads(-loss + pm, h_p, m_p))
        pm = pm.detach()
        if group is not None:
            gh, gm, pm, h_stats, m_stats = _pmean(group, gh, gm, pm, h_stats, m_stats)
        h_params, h_opt = opts["h"].update(gh, state.h_opt, state.h_params, alpha["h"])
        m_params, m_opt = opts["m"].update(gm, state.m_opt, state.m_params, alpha["m"])
        del loss, h_p, m_p

        # ---------------- generator phase -----------------
        dec_p = _leaves(state.dec_params)
        gen_loss, _, h_stats, m_stats = gan_forward(
            mods, cfg, enc_p, dec_p, h_params, m_params, h_stats, m_stats,
            real_data, z2, sigma, masks=gen_masks, pyramid=pyramid, real_smoothed=real_s, **hooks,
        )
        ge, gd = place.sum_grads("gen", _grads(gen_loss, enc_p, dec_p))
        gen_loss = gen_loss.detach()
        if group is not None:
            ge, gd, gen_loss, h_stats, m_stats = _pmean(group, ge, gd, gen_loss, h_stats, m_stats)
        enc_params, enc_opt = opts["enc"].update(ge, state.enc_opt, state.enc_params, alpha["enc"])
        dec_params, dec_opt = opts["dec"].update(gd, state.dec_opt, state.dec_params, alpha["dec"])

        new_state = TrainState(
            step=state.step + 1,
            rng=state.rng,
            enc_params=enc_params,
            dec_params=dec_params,
            h_params=h_params,
            m_params=m_params,
            h_stats=h_stats,
            m_stats=m_stats,
            enc_opt=enc_opt,
            dec_opt=dec_opt,
            h_opt=h_opt,
            m_opt=m_opt,
        )
        return new_state, gen_loss, pm

    def metrics(gen_loss, pm, sigma):
        return {"sinkhorn_loss": gen_loss, "pm": pm, "sigma": torch.tensor(sigma, dtype=torch.float32)}

    counts = {"eager": 0, "captures": 0, "replays": 0}

    def train_step(state: TrainState, real_data, generator=None, z=None, masks=None):
        counts["eager"] += 1
        rng, z1, z2 = noise(state.rng, real_data, generator, z)
        rng, (disc_masks, gen_masks) = phase_masks(rng, masks)
        sigma = step_sigma(state.step)
        new_state, gen_loss, pm = iterate(state, real_data, z1, z2, sigma, disc_masks, gen_masks)
        new_state.rng = rng
        return new_state, metrics(gen_loss, pm, sigma)

    graphs: dict = {}  # signature -> StepGraph, or None once its eager warm-up has run

    def capture(state, real_data, z):
        sigma = step_sigma(state.step)  # the same every step, or unread (smoothing off)
        if z is None:
            z = [torch.empty(noise_shape(real_data))] * 2

        def fn(carried, fresh):
            real, z1, z2, alphas = fresh
            new, gen_loss, pm = iterate(state_with_tensors(state, carried), real, z1, z2, sigma,
                                        alphas=dict(zip(GROUPS, alphas.unbind())))
            return [*state_tensors(new).values(), gen_loss, pm]

        return StepGraph(fn, list(state_tensors(state).values()), [real_data, *z, torch.empty(len(GROUPS))],
                         _KERNEL_COUNTERS + _COMM_COUNTERS)

    def graphed_step(state: TrainState, real_data, generator=None, z=None, masks=None):
        tensors = state_tensors(state)
        key = (
            tuple(real_data.shape), real_data.dtype, real_data.device,
            None if z is None else tuple((tuple(x.shape), x.dtype) for x in z),
            tuple((k, tuple(v.shape), v.dtype) for k, v in tensors.items()),
        )
        if key not in graphs:
            graphs[key] = None
            return train_step(state, real_data, generator, z, masks)
        graph = graphs[key]
        if graph is None:
            graph = graphs[key] = capture(state, real_data, z)
            counts["captures"] += 1
        rng, z1, z2 = noise(state.rng, real_data, generator, z, out=graph.buffers[1:3])
        # computed in float32 on the host, as each Adam computes its own eagerly
        adam_counts = [getattr(state, f"{g}_opt").count for g in GROUPS]
        alphas = torch.stack([opts[g].alpha(c) for g, c in zip(GROUPS, adam_counts)])
        outs = graph(list(tensors.values()), [real_data, z1, z2, alphas])
        counts["replays"] += 1
        new_state = state_with_tensors(state, outs[:-2], step=state.step + 1, rng=rng,
                                       counts=[c + 1 for c in adam_counts])
        return new_state, metrics(outs[-2], outs[-1], step_sigma(state.step))

    graphed = replays_graph(cfg, device, group=group, encode=encode, decode=decode, placement=placement)
    step = graphed_step if graphed else train_step
    step.counts = counts
    return step

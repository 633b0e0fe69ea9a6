"""GAN training step of the PyTorch port: discriminator phase, then
generator phase.

Counterpart of ``kccotgan_tpu/train/steps.py`` under its usual
configuration (``kernel='none'``, no dropout, sequential discriminators):

* the context is encoded once (``share_context_encoding``): the
  discriminator phase reads the pyramid detached, and the generator phase
  backpropagates through the same pyramid into the encoder, which is the
  port's form of the JAX step's ``jax.vjp``;
* discriminator phase: noise z1, the decoder in teacher forcing (no graph:
  none of its inputs needs a gradient), the four discriminator passes
  h(fake), h(real), m(real), m(fake) with the BatchNorm statistics chained
  in that order, the mixed Sinkhorn divergence and pM on ``m_real``;
  ``-loss + pM`` is minimized over h and m by two Keras-exact Adams;
* generator phase: new noise z2 against the updated discriminators,
  starting from the statistics the discriminator phase left; ``loss`` is
  minimized over the encoder and the decoder.

Recurrence engine, ``cfg.kernel_impl``: under ``'scan'`` (and ``'auto'``)
every ConvLSTM and LSTM recurrence runs its plain loop under autograd,
the counterpart of ``lax.scan``.  Under ``'pallas'`` each runs the fused
recurrence, as JAX's ``'pallas'`` does in its batch-major, unpacked
layout (``time_major=False, conv_packing='off'``): on the card the
ConvLSTM and LSTM forward kernels, and their backward kernels wherever
autograd needs a gradient.  The discriminator phase's decoder needs none
(its parameters, pyramid and noise carry no gradient), so it runs the
forward kernel alone.  The Sinkhorn solves go through the fused kernels
(``ot/cuda_sinkhorn.py``: one forward and one backward launch a phase)
unless ``cfg.sinkhorn_solver`` is ``'scan'``.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.func import functional_call

from ..config import check_trainable
from ..models.video import discriminator_modules, generator_modules
from ..ot import compute_sinkhorn_loss, martingale_regularization
from .state import TrainState, make_optimizers, split_key

__all__ = ["build_train_step", "gan_forward"]


class GanModules:
    """The four modules a config describes, on the meta device: they only
    describe the computation, every parameter comes from the state.  Their
    recurrences take the engine ``cfg.kernel_impl`` names."""

    def __init__(self, cfg):
        with torch.device("meta"):
            self.encoder, self.decoder = generator_modules(cfg)
            self.disc_h, self.disc_m = discriminator_modules(cfg)


def gan_forward(mods, cfg, dec_params, h_params, m_params, h_stats, m_stats, real_data, z,
                pyramid):
    """Decode (teacher forcing) from ``pyramid``, discriminate, and return
    ``(loss, pm, h_stats, m_stats)``: the mixed Sinkhorn divergence, pM
    on ``m_real`` and the chained BatchNorm statistics."""
    fake_pred = functional_call(mods.decoder, dec_params, (pyramid, z), {"training": True})
    fake = torch.cat([real_data[:, :, : cfg.int_time_steps], fake_pred], dim=2)
    real = real_data  # kernel='none': no smoothing
    h_fake, h_stats = functional_call(mods.disc_h, h_params, (fake, h_stats))
    h_real, h_stats = functional_call(mods.disc_h, h_params, (real, h_stats))
    m_real, m_stats = functional_call(mods.disc_m, m_params, (real, m_stats))
    m_fake, m_stats = functional_call(mods.disc_m, m_params, (fake, m_stats))
    scaling = cfg.effective_scaling
    loss = compute_sinkhorn_loss(
        real, fake, scaling, h_fake, m_real, h_real, m_fake,
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


def build_train_step(cfg, *, device="cuda") -> Callable:
    """Returns ``train_step(state, real_data, generator=None, z=None) ->
    (state, metrics)``.

    ``real_data`` is the film-strip batch ``[B, H, T, W, C]`` (context and
    future along axis 2) on ``device``.  ``z = (z1, z2)``, each
    ``[B, pred_time_steps, z_h, z_w, z_c]``, injects the two phases' noise;
    otherwise both are drawn with ``torch.randn`` on ``device`` from
    ``generator`` or, when none is given, from a generator seeded by a
    split of ``state.rng``, whose other half the new state carries.
    ``metrics`` is ``{"sinkhorn_loss", "pm", "sigma"}`` as 0-d tensors
    (the generator phase's loss, the discriminator phase's pM).
    ``cfg.kernel_impl`` picks the recurrences' engine (module
    docstring); ``cfg.sinkhorn_solver='scan'`` solves the Sinkhorn
    problems with the plain loop under autograd, the kernels' reference.
    The state passed in is left as it was.
    """
    check_trainable(cfg)
    mods = GanModules(cfg)
    opts = make_optimizers(cfg)
    m = cfg.model

    def train_step(state: TrainState, real_data, generator=None, z=None):
        rng = state.rng
        if z is None:
            if generator is None:
                rng, seed = split_key(rng)
                generator = torch.Generator(device=device).manual_seed(seed)
            shape = (real_data.shape[0], cfg.pred_time_steps, m.z_height, m.z_width, m.z_channels)
            z1 = torch.randn(shape, generator=generator, device=device)
            z2 = torch.randn(shape, generator=generator, device=device)
        else:
            z1, z2 = z
        sigma = torch.tensor(cfg.init_sigma, dtype=torch.float32)

        enc_p = _leaves(state.enc_params)

        def encode(params):
            return functional_call(mods.encoder, params, (real_data,))

        pyramid = encode(enc_p) if cfg.share_context_encoding else None

        # ---------------- discriminator phase -----------------
        h_p, m_p = _leaves(state.h_params), _leaves(state.m_params)
        pyr = [p.detach() for p in pyramid] if pyramid is not None else encode(state.enc_params)
        loss, pm, h_stats, m_stats = gan_forward(
            mods, cfg, state.dec_params, h_p, m_p, state.h_stats, state.m_stats,
            real_data, z1, pyr,
        )
        gh, gm = _grads(-loss + pm, h_p, m_p)
        h_params, h_opt = opts["h"].update(gh, state.h_opt, state.h_params)
        m_params, m_opt = opts["m"].update(gm, state.m_opt, state.m_params)
        del loss, h_p, m_p, pyr

        # ---------------- generator phase -----------------
        dec_p = _leaves(state.dec_params)
        pyr = pyramid if pyramid is not None else encode(enc_p)
        gen_loss, _, h_stats, m_stats = gan_forward(
            mods, cfg, dec_p, h_params, m_params, h_stats, m_stats,
            real_data, z2, pyr,
        )
        ge, gd = _grads(gen_loss, enc_p, dec_p)
        enc_params, enc_opt = opts["enc"].update(ge, state.enc_opt, state.enc_params)
        dec_params, dec_opt = opts["dec"].update(gd, state.dec_opt, state.dec_params)

        new_state = TrainState(
            step=state.step + 1,
            rng=rng,
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
        metrics = {"sinkhorn_loss": gen_loss.detach(), "pm": pm.detach(), "sigma": sigma}
        return new_state, metrics

    return train_step

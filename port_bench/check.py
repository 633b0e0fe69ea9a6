"""The comparison that decides ``correct``: the program's outputs from the
timed path against the plain reference on the same inputs and weights.

Training (``train_numbers``): the reference follows the first
``CHECK_STEPS`` steps from the same weights, batches and noise; compared
are each step's loss and pM (largest relative gap), the norm of each
leaf's first gradient as the optimizer got it (from the Adam state after
one step, ``g = mu / (1 - beta1)``), and the norm of each leaf's change
after the steps.  Both norms are taken by the worst leaf: the gap between
the program's norm and the reference's, over the reference's norm of that
leaf or of its group's median leaf, whichever is larger.  Leaves whose
reference gradient is under a thousandth of their group's median leaf
move by round-off alone and are left out of the change.

Sampling (``sample_numbers``): the largest absolute gap between a kept
request's predicted frames and the reference's rollout of the same
context and noise (``frames``); with best-of-K, the gap in dB between the
program's best-of-K PSNR and the reference's over the program's own K
predicted futures (``psnr``), the same gap of the best-of-K SSIM
(``ssim``), and the frames of ``check_rollouts`` of the K rollouts drawn
from the seed.

The reference runs with TF32 off, and leaves the flags as it found them.  ``precision`` puts the reference in a
lower precision (the control) or ``half_batch`` leaves half the batch out
(a fault); ``control_numbers`` compares such a reference with the plain one.
"""

from __future__ import annotations

import contextlib
import math
import statistics

import numpy as np
import torch

from .spec import sub_seed

__all__ = ["control_numbers", "judge", "reference_train", "sample_numbers", "train_numbers"]


@contextlib.contextmanager
def _tf32_off():
    """TF32 off for the reference, and the flags as they were after it, so
    that a later run of the program in the same process runs as it would
    alone."""
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


# ---------------------------------------------------------------- training


def _norms(d):
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in d.items()}


def train_outputs(cfg, loss, pm, mu1, params3, params0) -> dict:
    """The numbers a training run is judged by: per-step loss and pM, and
    per group and leaf the norms of the first gradient and of the change."""
    b1 = cfg["beta1"]
    return {
        "loss": list(loss), "pm": list(pm),
        "grad": {g: {k: n / (1.0 - b1) for k, n in _norms(mu1[g]).items()} for g in mu1},
        "change": {g: _norms({k: params3[g][k] - params0[g][k] for k in params3[g]}) for g in params3},
    }


def reference_train(ref, cfg, ev, device, precision=None, half_batch=False) -> dict:
    """The reference's ``train_outputs`` over the evidence's steps."""
    with _tf32_off():
        return _reference_train(ref, cfg, ev, device, precision, half_batch)


def _reference_train(ref, cfg, ev, device, precision, half_batch) -> dict:
    prec = ref.Precision(precision or cfg["compute_dtype"])
    clone = {g: {k: v.clone() for k, v in p.items()} for g, p in ev["params0"].items()}
    state = ref.train_state(clone, {g: {k: v.clone() for k, v in s.items()} for g, s in ev["stats0"].items()})
    loss, pm, mu1 = [], [], None
    for real, (z1, z2) in zip(ev["batches"], ev["z"]):
        real = torch.as_tensor(real, device=device)
        if half_batch:
            n = real.shape[0] // 2
            real, z1, z2 = real[:n], z1[:n], z2[:n]
        state, met = ref.train_step(cfg, state, real, z1, z2, prec)
        loss.append(float(met["loss"]))
        pm.append(float(met["pm"]))
        if mu1 is None:
            mu1 = {g: opt[1] for g, opt in state["opt"].items()}
    return train_outputs(cfg, loss, pm, mu1, state["params"], ev["params0"])


def _worst(got: dict, want: dict, leaves=None) -> float:
    """Worst leaf of ``|got - want| / max(want, median of want)``."""
    keys = [k for k in want if leaves is None or k in leaves]
    med = statistics.median(want[k] for k in keys)
    return max(abs(got[k] - want[k]) / max(want[k], med) for k in keys)


def compare_train(got: dict, want: dict) -> dict:
    def rel(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))

    grad = change = 0.0
    for g, ref_grad in want["grad"].items():
        grad = max(grad, _worst(got["grad"][g], ref_grad))
        med = statistics.median(ref_grad.values())
        moving = {k for k, n in ref_grad.items() if n >= 1e-3 * med}
        change = max(change, _worst(got["change"][g], want["change"][g], moving))
    return {"loss": rel(got["loss"], want["loss"]), "pm": rel(got["pm"], want["pm"]), "grad": grad, "change": change}


def train_numbers(ref, cfg, ev, device) -> dict:
    got = train_outputs(cfg, ev["loss"], ev["pm"], ev["mu1"], ev["params3"], ev["params0"])
    return compare_train(got, reference_train(ref, cfg, ev, device))


# ---------------------------------------------------------------- sampling


def _gen(ev):
    return {"encoder": ev["params0"]["enc"], "decoder": ev["params0"]["dec"]}


def _predicted(ref, cfg, ev, inputs, z, prec, device):
    tc = cfg["int_time_steps"]
    ctx = torch.as_tensor(inputs[:, :, :tc], device=device)
    with torch.no_grad():
        return ref.rollout(cfg, _gen(ev), ctx, z, prec)[:, :, tc:]


def _picked(ev, req) -> list:
    """Which rollouts of a kept request the frames check reruns: the
    first, and with best-of-K ``check_rollouts - 1`` of the K drawn from
    the seed."""
    k = ev["metrics_k"]
    if not k:
        return [0]
    rng = np.random.default_rng(sub_seed(ev["seed"], f"rollouts{req['index']}"))
    return [0] + sorted((1 + rng.choice(k, ev["check_rollouts"] - 1, replace=False)).tolist())


def _futures(ev, req, device) -> list:
    """A kept request's K scored futures, on ``device``."""
    return [torch.as_tensor(f, device=device) for f in req["futures"][1:]]


def sample_numbers(ref, cfg, ev, device) -> dict:
    if not ev["requests"]:
        return {}
    with _tf32_off():
        prec = ref.Precision(cfg["compute_dtype"])
        tc = cfg["int_time_steps"]
        frames = psnr = ssim = 0.0
        for req in ev["requests"]:
            for j in _picked(ev, req):
                want = _predicted(ref, cfg, ev, req["inputs"], req["z"][j], prec, device)
                got = req["frames"][:, :, tc:] if j == 0 else req["futures"][j]
                got = torch.as_tensor(got, device=device)
                frames = max(frames, float((got.float() - want.float()).abs().max()))
            if ev["metrics_k"]:
                truth = torch.as_tensor(req["inputs"][:, :, tc:], device=device)
                best_ps, best_ss = ref.best_of_k(_futures(ev, req, device), truth)
                psnr = max(psnr, abs(req["scores"]["psnr"] - float(best_ps)))
                ssim = max(ssim, abs(req["scores"]["ssim"] - float(best_ss)))
    out = {"frames": frames}
    if ev["metrics_k"]:
        out.update(psnr=psnr, ssim=ssim)
    return out


# ----------------------------------------------------------------- control


def control_numbers(ref, cfg, ev, device, precision: str = "float8") -> dict:
    """The numbers the reference in ``precision`` reads when put in the
    program's place (scores: best-of-K PSNR and SSIM computed in
    bfloat16)."""
    if ev["kind"] == "train":
        want = reference_train(ref, cfg, ev, device)
        return compare_train(reference_train(ref, cfg, ev, device, precision=precision), want)
    with _tf32_off():
        plain, low = ref.Precision(cfg["compute_dtype"]), ref.Precision(precision)
        tc = cfg["int_time_steps"]
        frames = psnr = ssim = 0.0
        for req in ev["requests"]:
            for j in _picked(ev, req):
                a = _predicted(ref, cfg, ev, req["inputs"], req["z"][j], plain, device)
                b = _predicted(ref, cfg, ev, req["inputs"], req["z"][j], low, device)
                frames = max(frames, float((a - b).abs().max()))
            if ev["metrics_k"]:
                truth = torch.as_tensor(req["inputs"][:, :, tc:], device=device)
                futures = _futures(ev, req, device)
                best_ps, best_ss = ref.best_of_k(futures, truth)
                low_ps, low_ss = ref.best_of_k(futures, truth, dtype=torch.bfloat16)
                psnr = max(psnr, abs(float(low_ps) - float(best_ps)))
                ssim = max(ssim, abs(float(low_ss) - float(best_ss)))
    out = {"frames": frames}
    if ev["metrics_k"]:
        out.update(psnr=psnr, ssim=ssim)
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})``: every limit has its
    number, finite and at or under the limit."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and math.isfinite(value) and value <= limit
        ok = ok and good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks

"""The port's sequence parallelism (``kccotgan_tpu_torch/parallel``:
``seqpar``, ``seqmodel``, ``seqtrain``) on CPU ranks of a gloo job.

Ranks are spawned once per world size for this file (``jobs``, through
``tests/_torch_dist.py``); the references run in the test process
meanwhile.  Seq size 2 (W = 2), then the 2-D data 2 x seq 2 mesh (W = 4).

* ``time_sharded_scan``, the ring relay, of the plain ConvLSTM
  recurrence and of the kernel engine's (its plain versions on the CPU)
  against the unsharded scan: the forward equal to the bit (the same
  steps from the same carry), ``dx, dh0, dc0, drk, db`` at rtol 1e-6
  (each rank's weight gradients are its chunk's part; summed, the
  whole's); ``ConvLSTM2D(seq_axis=...)`` and ``LSTM(seq_axis=...)``
  against the layers without it.
* ``time_sharded_encode`` / ``time_sharded_decode`` against the unsharded
  encoder and decoder, forward and parameter gradients, at rtol 1e-6
  (the input convs run over fewer frames at once).
* ``build_seq_train_step`` against the port's one-device step, with and
  without dropout, at S = 2 and on the 2-D mesh, at the exact mode's
  tolerances (``_torch_dist.assert_states_match``); the state the same
  on every rank to the bit.
* The divisibility errors, and ``cli.main --seq_devices 2``.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

from kccotgan_tpu_torch.cli.main import main
from kccotgan_tpu_torch.config import ModelConfig, TrainConfig
from kccotgan_tpu_torch.models.cuda_convlstm import convlstm_scan, convlstm_scan_reference
from kccotgan_tpu_torch.models.layers import LSTM, ConvLSTM2D
from kccotgan_tpu_torch.models.video import generator_modules
from kccotgan_tpu_torch.parallel import data_seq_mesh, seq_mesh, time_sharded_scan
from kccotgan_tpu_torch.parallel.mesh import Mesh
from kccotgan_tpu_torch.parallel.seqmodel import time_sharded_decode, time_sharded_encode
from kccotgan_tpu_torch.parallel.seqtrain import build_seq_train_step
from kccotgan_tpu_torch.parallel.sharding import replicate_state, shard_batch
from kccotgan_tpu_torch.train import build_train_step, create_train_state
from kccotgan_tpu_torch.weights import init_generator_params
from tests import _torch_dist

torch.set_num_threads(1)

CFG = TrainConfig(
    dname="synthetic", batch_size=4, total_time_steps=4, int_time_steps=2, sinkhorn_l=3, warmup_steps=1,
    compute_dtype="float32",
    model=ModelConfig(x_height=16, x_width=16, g_filter_size=2, d_filter_size=1, d_state_size=2,
                      z_channels=2, z_height=1, z_width=1),
)
STEP_CASES = {
    "plain": {},
    "dropout": {"kernel_impl": "pallas", "model": dataclasses.replace(CFG.model, dropout=0.1, rnn_dropout=0.1)},
}
STEPS = 2
T = 6  # the recurrence's frames, 3 a rank


def _cfg(case):
    return dataclasses.replace(CFG, **STEP_CASES[case])


def _video(cfg):
    return np.random.default_rng(1).uniform(size=(cfg.batch_size, 16, cfg.total_time_steps, 16, 1)).astype(np.float32)


def _scan_inputs():
    """xconv [2, T, 4, 4, 4f], (h0, c0) [2, 4, 4, f], rk [3, 3, f, 4f], b [4f],
    cotangents of (y, h_n, c_n), f = 2."""
    rng = np.random.default_rng(0)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32))

    return (t(2, T, 4, 4, 8), t(2, 4, 4, 2, scale=0.5), t(2, 4, 4, 2, scale=0.5), t(3, 3, 2, 8, scale=0.3),
            t(8, scale=0.1)), (t(2, T, 4, 4, 2), t(2, 4, 4, 2), t(2, 4, 4, 2))


ENGINES = {"plain": convlstm_scan_reference, "kernel": convlstm_scan}


def _grads(engine, args, cots, chunk=None, group=None):
    """``(y, h_n, c_n)`` and the gradients of ``sum(y * dy) + h_n * dh +
    c_n * dc`` with respect to the inputs, unsharded or on ``chunk`` of the
    frames through the relay."""
    args = [a.clone().requires_grad_() for a in args]
    xs = args[0] if chunk is None else args[0][:, chunk]
    scan = ENGINES[engine]
    if group is None:
        y, (h, c) = scan(xs, *args[1:])
        dy = cots[0]
    else:
        y, (h, c) = time_sharded_scan(scan, xs, *args[1:], group=group, name="test")
        dy = cots[0][:, chunk]
    loss = (y * dy).sum() + (h * cots[1]).sum() + (c * cots[2]).sum()
    return (y.detach(), h.detach(), c.detach()), torch.autograd.grad(loss, args, allow_unused=True)


def _layers(rank, group):
    """``ConvLSTM2D`` and ``LSTM`` with ``seq_axis`` on this rank's frames."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(2, T, 8, 8, 3)).astype(np.float32))
    xl = torch.from_numpy(rng.normal(size=(2, T, 5)).astype(np.float32))
    chunk = slice(rank * T // 2, (rank + 1) * T // 2)
    conv = ConvLSTM2D(3, 2, (3, 3), strides=(2, 2), seq_axis=group, name="probe")
    conv.reset_parameters(torch.Generator().manual_seed(0))
    lstm = LSTM(5, 3, seq_axis=group, plain=True)
    lstm.reset_parameters(torch.Generator().manual_seed(1))
    y, (h, c) = conv(x[:, chunk])
    return {"convlstm": (y.detach(), h.detach(), c.detach()), "lstm": lstm(xl[:, chunk]).detach()}


def _gen_inputs(cfg):
    rng = np.random.default_rng(2)
    video = torch.from_numpy(_video(cfg))
    z = torch.from_numpy(rng.normal(size=(cfg.batch_size, cfg.pred_time_steps, 1, 1, 2)).astype(np.float32))
    cot = torch.from_numpy(rng.normal(size=(cfg.batch_size, 16, cfg.pred_time_steps, 16, 1)).astype(np.float32))
    params = init_generator_params(cfg, torch.Generator().manual_seed(0))
    return video, z, cot, params


def _encode_decode(rank, group):
    """The time-sharded encoder and decoder on this rank's chunks: the
    pyramid, the frames, and the parameters' gradients of ``sum(frames *
    cot)`` (this rank's part)."""
    cfg = CFG
    video, z, cot, params = _gen_inputs(cfg)
    with torch.device("meta"):
        enc, dec = generator_modules(cfg, seq_axis=group)
    enc_p = {k: v.clone().requires_grad_() for k, v in params["encoder"].items()}
    dec_p = {k: v.clone().requires_grad_() for k, v in params["decoder"].items()}
    pyramid = time_sharded_encode(enc, enc_p, video, group)
    frames = time_sharded_decode(dec, dec_p, pyramid, z, group, int_time_steps=cfg.int_time_steps)
    n = cfg.pred_time_steps // 2
    loss = (frames * cot[:, :, rank * n : (rank + 1) * n]).sum()
    grads = torch.autograd.grad(loss, [*enc_p.values(), *dec_p.values()])
    names = [f"encoder.{k}" for k in enc_p] + [f"decoder.{k}" for k in dec_p]
    return {"pyramid": [p.detach() for p in pyramid], "frames": frames.detach(), "grads": dict(zip(names, grads))}


def _seq_step(rank, dev, case, mesh):
    cfg = _cfg(case)
    step = build_seq_train_step(cfg, mesh)
    state = replicate_state(create_train_state(cfg, device=dev), mesh)
    rows = torch.from_numpy(shard_batch(_video(cfg), mesh))
    mets, states = [], []
    for _ in range(STEPS):
        state, met = step(state, rows)
        mets.append((float(met["sinkhorn_loss"]), float(met["pm"])))
        states.append(_torch_dist.state_np(state))
    return {"metrics": mets, "states": states}


def run_s2(rank, dev):
    group = dist.group.WORLD
    args, cots = _scan_inputs()
    chunk = slice(rank * T // 2, (rank + 1) * T // 2)
    out = {"scan": {e: _grads(e, args, cots, chunk, group) for e in ENGINES}}
    out["layers"] = _layers(rank, group)
    out["encode_decode"] = _encode_decode(rank, group)
    mesh = seq_mesh(2, device=dev)
    out["step"] = {case: _seq_step(rank, dev, case, mesh) for case in STEP_CASES}
    return out


def run_2d(rank, dev):
    mesh = data_seq_mesh(2, 2, device=dev)
    return {"step": {case: _seq_step(rank, dev, case, mesh) for case in STEP_CASES}}


def _one_device(case):
    cfg = _cfg(case)
    step = build_train_step(cfg, device="cpu")
    state, mets, states = create_train_state(cfg, device="cpu"), [], []
    for _ in range(STEPS):
        state, met = step(state, torch.from_numpy(_video(cfg)))
        mets.append((float(met["sinkhorn_loss"]), float(met["pm"])))
        states.append(_torch_dist.state_np(state))
    return mets, states


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """``(S = 2 ranks' results, 2-D ranks' results, one-device runs)``."""
    tmp2, tmp4 = tmp_path_factory.mktemp("s2"), tmp_path_factory.mktemp("d2s2")
    s2 = _torch_dist.start(run_s2, 2, store_dir=tmp2)
    d2 = _torch_dist.start(run_2d, 4, store_dir=tmp4)
    refs = {case: _one_device(case) for case in STEP_CASES}
    return s2.result(), d2.result(), refs


@pytest.mark.parametrize("engine", list(ENGINES))
def test_ring_relay_equals_the_scan(engine, jobs):
    args, cots = _scan_inputs()
    (y, h, c), grads = _grads(engine, args, cots)
    results = jobs[0]
    for r, res in enumerate(results):
        (yr, hr, cr), _ = res["scan"][engine]
        np.testing.assert_array_equal(yr, y[:, r * T // 2 : (r + 1) * T // 2].numpy())
        np.testing.assert_array_equal(hr, h.numpy())  # the final carry on every rank
        np.testing.assert_array_equal(cr, c.numpy())
    dx = np.concatenate([res["scan"][engine][1][0][:, r * T // 2 : (r + 1) * T // 2]
                         for r, res in enumerate(results)], axis=1)
    np.testing.assert_allclose(dx, grads[0].numpy(), rtol=1e-6, atol=1e-7)
    # dh0, dc0 reach rank 0 only (the others start from the relayed carry)
    for i, name in ((1, "dh0"), (2, "dc0")):
        np.testing.assert_allclose(results[0]["scan"][engine][1][i], grads[i].numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=name)
        assert results[1]["scan"][engine][1][i] is None
    for i, name in ((3, "drk"), (4, "db")):
        total = sum(res["scan"][engine][1][i] for res in results)
        np.testing.assert_allclose(total, grads[i].numpy(), rtol=1e-6, atol=1e-6, err_msg=name)


def test_layers_take_a_seq_group(jobs):
    """``ConvLSTM2D`` and ``LSTM`` with ``seq_axis``: the rank's frames and
    the final state of the layer without it."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(2, T, 8, 8, 3)).astype(np.float32))
    xl = torch.from_numpy(rng.normal(size=(2, T, 5)).astype(np.float32))
    conv = ConvLSTM2D(3, 2, (3, 3), strides=(2, 2), name="probe")
    conv.reset_parameters(torch.Generator().manual_seed(0))
    lstm = LSTM(5, 3, plain=True)
    lstm.reset_parameters(torch.Generator().manual_seed(1))
    y, (h, c) = conv(x)
    yl = lstm(xl)
    for r, res in enumerate(jobs[0]):
        chunk = slice(r * T // 2, (r + 1) * T // 2)
        gy, gh, gc = res["layers"]["convlstm"]
        np.testing.assert_allclose(gy, y[:, chunk].detach(), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(gh, h.detach(), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(gc, c.detach(), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(res["layers"]["lstm"], yl[:, chunk].detach(), rtol=1e-6, atol=1e-7)


def test_time_sharded_encode_and_decode_equal_the_modules(jobs):
    cfg = CFG
    video, z, cot, params = _gen_inputs(cfg)
    with torch.device("meta"):
        enc, dec = generator_modules(cfg)
    enc_p = {k: v.clone().requires_grad_() for k, v in params["encoder"].items()}
    dec_p = {k: v.clone().requires_grad_() for k, v in params["decoder"].items()}
    pyramid = torch.func.functional_call(enc, enc_p, (video,), {"training": True, "slice_time": False})
    frames = torch.func.functional_call(dec, dec_p, ([p[:, cfg.int_time_steps - 1 :] for p in pyramid], z),
                                        {"training": True})
    grads = torch.autograd.grad((frames * cot).sum(), [*enc_p.values(), *dec_p.values()])
    names = [f"encoder.{k}" for k in enc_p] + [f"decoder.{k}" for k in dec_p]
    results = jobs[0]
    t, n = cfg.total_time_steps // 2, cfg.pred_time_steps // 2
    for r, res in enumerate(results):
        got = res["encode_decode"]
        for level, want in zip(got["pyramid"], pyramid):
            np.testing.assert_allclose(level, want[:, r * t : (r + 1) * t].detach(), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(got["frames"], frames[:, :, r * n : (r + 1) * n].detach(), rtol=1e-6, atol=1e-7)
    for name, want in zip(names, grads):
        total = sum(res["encode_decode"]["grads"][name] for res in results)
        scale = float(want.abs().max())
        np.testing.assert_allclose(total, want, rtol=1e-6, atol=1e-6 * scale, err_msg=name)


@pytest.mark.parametrize("mesh", ["seq2", "data2_seq2"])
@pytest.mark.parametrize("case", list(STEP_CASES))
def test_seq_step_equals_one_device_step(case, mesh, jobs):
    results = jobs[0] if mesh == "seq2" else jobs[1]
    want_metrics, wants = jobs[2][case]
    got = results[0]["step"][case]
    _torch_dist.assert_states_match(got["states"], wants, got["metrics"], want_metrics, CFG.lr)
    _torch_dist.assert_ranks_equal(results, lambda r: r["step"][case]["states"][-1])


def _mesh(data, seq):
    return Mesh(data, seq, 0, torch.device("cpu"), None, None, None, None)


@pytest.mark.parametrize("over,data,seq,message", [
    ({}, 1, 3, "seq mesh size 3 must divide total_time_steps"),
    ({"total_time_steps": 6, "int_time_steps": 3}, 1, 2, "must divide total_time_steps (6) and pred_time_steps (3)"),
    ({}, 3, 2, "data mesh size 3 must divide batch_size"),
])
def test_seq_step_refuses_what_does_not_divide(over, data, seq, message):
    with pytest.raises(ValueError, match=message.replace("(", r"\(").replace(")", r"\)")):
        build_seq_train_step(dataclasses.replace(CFG, **over), _mesh(data, seq))


def test_cli_trains_on_a_seq_mesh(tmp_path, capsys):
    flags = ["--dname", "synthetic", "-bs", "2", "-tts", "4", "-its", "2", "-sinkl", "3", "-xh", "16", "-xw", "16",
             "-gfs", "2", "-dfs", "1", "-dss", "2", "-nz", "2", "-ne", "1", "--max_steps", "2",
             "--compute_dtype", "float32", "--seq_devices", "2", "--out_dir", str(tmp_path), "--run_name", "seq"]
    rc = main(flags, device="cpu")
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and summary["status"] == "completed" and summary["steps"] == 2
    assert (summary["num_devices"], summary["seq_devices"], summary["dist_backend"]) == (1, 2, "gloo")
    logged = {}
    with open(tmp_path / "seq" / "log" / "metrics.jsonl") as f:
        for line in f:
            r = json.loads(line)
            logged.setdefault(r["tag"], []).append(r["step"])
    assert logged["Sinkhorn Loss"] == [1, 2]  # rank 0 alone logs

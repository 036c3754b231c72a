"""The plain reference (``benchmark/reference``) against the port's plain
path at a tiny size on the CPU, in f32: the forward of every branch type
the port trains, the loss and the metric, the deploy fold, the int8 tables
and frames, three training steps with Adam and a val sweep; and that each
branch the parity tolerance guards moves the forward by far more."""

import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent), str(Path(__file__).parent)]

from harness import inputs  # noqa: E402
from harness.program import load_weights, model_config, train_config  # noqa: E402
from reference import loss as L  # noqa: E402
from reference import model as M  # noqa: E402
from reference import train as T  # noqa: E402
from repnerv_tpu_torch.data.frames import FrameStore  # noqa: E402
from repnerv_tpu_torch.models.embedding import positional_encoding  # noqa: E402
from repnerv_tpu_torch.models.generator import (  # noqa: E402
    Generator, calibrate_int8, generator_to_deploy)
from repnerv_tpu_torch.ops.losses import multi_scale_loss  # noqa: E402
from repnerv_tpu_torch.ops.ssim import ms_ssim  # noqa: E402
from repnerv_tpu_torch.train.loop import build_train_step_fn, make_optimizer  # noqa: E402
from tiny import TINY_MODEL, TINY_VIDEO  # noqa: E402

BRANCHES = ("ERB", "NeRV_vanilla", "ACB", "RepVGG", "DBB", "ECB")
# millions of training parameters at the 720p widths (the port's Generator)
PARAMS_720P = {"ERB": 7.58, "NeRV_vanilla": 3.20, "ACB": 4.03, "RepVGG": 3.34, "DBB": 6.01,
               "ECB": 6.17}
SEED = 2 ** 31 + 12345  # the driver's seeds are this large
FORWARD_ATOL = 2e-6  # the reference's forward against the port's
GRAD_ATOL = 1e-7  # each gradient element's
# Where a first-step gradient is under GRAD_ATOL, round-off in it sets an
# order-one share of Adam's first update, lr g / (|g| + eps).  This seed's
# DBB draw has one such element (layers.2.rbr_1x1_3x3_branch_3x3.weight
# [13, 6, 1, 1]: g 1.43e-8 against the reference's 1.36e-8, its change off by
# 0.8%), so there those elements are held to Adam over the port's own
# gradients and not to the reference's change.
ADAM_EDGE = ("DBB",)


def tiny_cfg(branch, dtype="float32"):
    cfg = json.loads((HERE / "configs" / "erb-720p.json").read_text())
    cfg["model"].update(TINY_MODEL, branch_type=branch, compute_dtype=dtype)
    cfg["video"] = dict(TINY_VIDEO)
    return cfg


def adam_change(p0, grads, t, steps_per_epoch):
    """The change that ``reference/train.py``'s Adam makes to ``p0`` (one
    leaf) from ``grads``, one a step, with that file's arithmetic."""
    b1, b2, eps = t["beta"], 0.999, 1e-8
    mom, vel, v = torch.zeros_like(p0), torch.zeros_like(p0), p0.clone()
    for n, g in enumerate(grads):
        mom.mul_(b1).add_(g, alpha=1 - b1)
        vel.mul_(b2).addcmul_(g, g, value=1 - b2)
        bc1, bc2 = 1 - b1 ** (n + 1), 1 - b2 ** (n + 1)
        lr = T.lr_at(n, t, steps_per_epoch)
        v.addcdiv_(mom, vel.sqrt() / math.sqrt(bc2) + eps, value=-lr / bc1)
    return v - p0


def port_model(cfg, p0):
    model = Generator(model_config(cfg), seed=0, device="cpu")
    return load_weights(model, p0)


@pytest.mark.parametrize("branch", BRANCHES)
def test_the_reference_forward_is_the_ports_train_forward(branch):
    cfg = tiny_cfg(branch)
    m = cfg["model"]
    p0 = inputs.weights(M.param_shapes(m), SEED, "cpu")
    model = port_model(cfg, p0).train()
    t = torch.tensor([0.0, 0.25, 0.5])
    got = model(positional_encoding(t, m["embed"]))[-1]
    want = M.forward(p0, m, t).permute(0, 2, 3, 1)
    assert got.shape == want.shape == (3, 24, 32, 3)
    torch.testing.assert_close(got, want, rtol=0, atol=FORWARD_ATOL)


@pytest.mark.parametrize("branch", BRANCHES)
def test_the_reference_names_every_parameter_the_port_trains(branch):
    m = tiny_cfg(branch)["model"]
    names = {n: s for n, s, _ in M.param_shapes(m)}
    model = Generator(model_config(tiny_cfg(branch)), seed=0, device="cpu")
    assert names == {k: tuple(v.shape) for k, v in model.named_parameters()}
    full = json.loads((HERE / "configs" / "erb-720p.json").read_text())["model"]
    n = sum(int(np.prod(s)) for _, s, _ in M.param_shapes({**full, "branch_type": branch}))
    assert n / 1e6 == pytest.approx(PARAMS_720P[branch], abs=0.005)


@pytest.mark.parametrize("branch, zeroed", [
    ("ECB", ("rbr_conv1x1_sbx_branch.scale", "rbr_conv1x1_sbx_branch.bias")),
    ("ECB", ("rbr_conv1x1_sby_branch.scale", "rbr_conv1x1_sby_branch.bias")),
    ("ECB", ("rbr_conv1x1_lpl_branch.scale", "rbr_conv1x1_lpl_branch.bias")),
    ("DBB", ("rbr_1x1_avg_branch_1x1.weight",)),
])
def test_each_branch_moves_the_forward_past_the_parity_tolerance(branch, zeroed):
    """A branch whose weights are zero in every block adds nothing; leaving
    it out so moves the tiny forward by more than 20x the tolerance the
    port's forward is held to, so the parity test would see it missing."""
    m = tiny_cfg(branch)["model"]
    p0 = inputs.weights(M.param_shapes(m), SEED, "cpu")
    hit = [k for k in p0 if k.split(".", 2)[-1] in zeroed]  # "layers.<i>." left off
    assert len(hit) == 3 * len(zeroed)  # in each of the tiny model's three blocks
    gone = {k: torch.zeros_like(v) if k in hit else v for k, v in p0.items()}
    t = torch.tensor([0.0, 0.25, 0.5])
    with torch.no_grad():
        moved = (M.forward(p0, m, t) - M.forward(gone, m, t)).abs().max()
    assert moved > 20 * FORWARD_ATOL


def test_the_reference_loss_and_metric_are_the_ports():
    g = torch.Generator().manual_seed(3)
    x = torch.rand(2, 176, 192, 3, generator=g)
    y = (x + 0.1 * torch.rand(2, 176, 192, 3, generator=g)).clamp(0, 1)
    got = multi_scale_loss([x], [y], "Fusion6")
    want = L.fusion6(x.permute(0, 3, 1, 2), y.permute(0, 3, 1, 2))
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    # the contrast terms, E[x^2] - E[x]^2 near 1, cancel: f32 rounding of
    # two blurs summed in other orders moves the fifth digit
    torch.testing.assert_close(ms_ssim(x, y), L.ms_ssim(x.permute(0, 3, 1, 2), y.permute(0, 3, 1, 2)),
                               rtol=1e-5, atol=0)


@pytest.mark.parametrize("branch", BRANCHES)
def test_the_reference_deploy_fold_is_the_ports(branch):
    cfg = tiny_cfg(branch)
    m = cfg["model"]
    p0 = inputs.weights(M.param_shapes(m), SEED, "cpu")
    dep = generator_to_deploy(port_model(cfg, p0))
    for blk, (k, b) in zip(dep.layers, M.deploy_fold(p0, m)):
        torch.testing.assert_close(blk.rbr_reparam.weight, k, rtol=0, atol=1e-6)
        torch.testing.assert_close(blk.rbr_reparam.bias, b, rtol=0, atol=1e-6)
    t = torch.tensor([0.125, 0.75])
    with torch.no_grad():
        got = dep.eval()(positional_encoding(t, m["embed"]))[-1]
    want = M.deploy_forward(p0, m, M.deploy_fold(p0, m), t).permute(0, 2, 3, 1)
    torch.testing.assert_close(got, want, rtol=0, atol=FORWARD_ATOL)


def test_the_reference_int8_tail_is_the_ports():
    cfg = tiny_cfg("ERB")
    m = cfg["model"]
    p0 = inputs.weights(M.param_shapes(m), SEED, "cpu")
    dep = generator_to_deploy(port_model(cfg, p0))
    dep.cfg.decode_int8, dep.cfg.int8_from_block = True, -2
    calib = inputs.frame_times(4)[:4]
    q = calibrate_int8(dep, positional_encoding(calib, m["embed"]))
    folded = M.deploy_fold(p0, m)
    ref = M.int8_tables(p0, m, folded, calib, -2)
    assert ref["first"] == 1 and sorted(q.int8) == ["1", "2"]
    for i in (1, 2):
        e, r = q.int8[str(i)], ref["blocks"][i]
        torch.testing.assert_close(e.in_scale, r["in_scale"], rtol=1e-6, atol=0)
        # HWIO -> OIHW; a weight on a rounding edge may round the other way
        w = e.w_q.permute(3, 2, 0, 1).float()
        assert (w - r["w_q"]).abs().max() <= 1 and (w != r["w_q"]).float().mean() < 1e-3
    t = torch.tensor([0.0, 0.5])
    with torch.no_grad():
        got = q.eval()(positional_encoding(t, m["embed"]))[-1]
    want = M.deploy_forward(p0, m, folded, t, int8=ref).permute(0, 2, 3, 1)
    assert (got - want).abs().max() < 2e-3  # a code flipped by one step at most here and there


@pytest.mark.parametrize("branch", BRANCHES)
def test_three_reference_steps_are_the_ports_eager_steps(branch):
    cfg = tiny_cfg(branch)
    m = cfg["model"]
    traffic = {"batch_size": 1}
    tcfg = train_config(cfg, traffic, SEED)
    p0 = inputs.weights(M.param_shapes(m), SEED, "cpu")
    frames = inputs.video(4, 24, 32, SEED, "cpu")
    times = inputs.frame_times(4)
    model = port_model(cfg, p0).train()
    from repnerv_tpu_torch.train.loop import TrainState

    state = TrainState(model, make_optimizer(tcfg, model), 0)
    step = build_train_step_fn(tcfg, 4, with_msssim=False)
    store = FrameStore(frames=frames, t=times.numpy())
    rows = [[2], [0], [3]]
    losses, grads = [], []
    for r in rows:
        idx = torch.tensor(r)
        state, aux = step(state, store.gather(idx), times[idx])
        losses.append(float(aux["loss"]))
        grads.append({k: p.grad.clone() for k, p in model.named_parameters()})
    ref = T.steps(p0, m, cfg["train"], frames, times, rows, 4)
    np.testing.assert_allclose(losses, ref["loss"], rtol=2e-6)
    for k, p in model.named_parameters():
        for got, want in zip(grads, ref["grads"]):
            torch.testing.assert_close(got[k], want[k], rtol=1e-4, atol=GRAD_ATOL)
        torch.testing.assert_close(p.detach(), ref["params"][k], rtol=0, atol=1e-6)
        # the change itself, not only the sum with p0: every element's is the
        # reference's Adam over the port's own gradients
        change = p.detach() - p0[k]
        adam = adam_change(p0[k], [g[k] for g in grads], cfg["train"], 4)
        torch.testing.assert_close(change, adam, rtol=2e-3, atol=1e-7)
        # and the reference's change: in ADAM_EDGE's types, where the first
        # step's gradient reaches GRAD_ATOL
        want = ref["params"][k] - p0[k]
        if branch in ADAM_EDGE:
            sure = ref["grads"][0][k].abs() >= GRAD_ATOL
            change, want = change[sure], want[sure]
        torch.testing.assert_close(change, want, rtol=2e-3, atol=1e-7)


@pytest.mark.parametrize("branch", BRANCHES)
def test_the_reference_sweep_is_the_ports_eval(branch):
    """Each frame's PSNR of the port's val sweep (``evaluate`` over the
    eval step) is the reference's, under the same training weights."""
    from repnerv_tpu_torch.train.loop import evaluate, make_eval_step

    cfg = tiny_cfg(branch)
    m = cfg["model"]
    tcfg = train_config(cfg, {"batch_size": 1}, SEED)
    p0 = inputs.weights(M.param_shapes(m), SEED, "cpu")
    frames = inputs.video(4, 24, 32, SEED, "cpu")
    times = inputs.frame_times(4)
    store = FrameStore(frames=frames, t=times.numpy())
    got = []
    step = make_eval_step(tcfg, with_msssim=False)

    def recorded(model, f, t):
        outs, aux = step(model, f, t)
        got.append(float(aux["psnr"][0, -1]))
        return outs, aux

    psnr, _ = evaluate(port_model(cfg, p0).train(), recorded, store, tcfg)
    ref = T.sweep(p0, m, frames, times, list(range(4)), 1)
    assert ref["msssim"] is None
    np.testing.assert_allclose(got, ref["psnr"], rtol=1e-5)
    np.testing.assert_allclose(psnr[-1], np.mean(ref["psnr"]), rtol=1e-5)

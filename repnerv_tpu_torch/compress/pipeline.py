"""Compression pipeline: prune -> [finetune / QAT] -> deploy -> quantize ->
Huffman / rANS -> ``.rnvb`` (port of ``repnerv_tpu/compress/pipeline.py``).

* PATH A (``finetune`` with prune_ratio < 1): the train-state model is
  pruned by global L1 masks and finetuned with a FRESH Adam (masks on
  gradients and weights) through the fused epoch (``make_epoch_fn``, or
  ``make_streaming_epoch_fn`` for a video on the host or on disk, driven by
  ``run_fused_epoch``; the masks and the QAT transform inside its captured
  step) as the JAX package does with ``fused_epoch`` and no step limit, else
  through ``make_train_step`` (on the card a CUDA graph replay a step) and
  ``run_epoch``; then its branches fuse for
  deploy.  ``finetune_lr_mode`` "fresh" runs a new warmup + decay over
  ``finetune_epochs``; "reference" continues the original schedule from the
  checkpoint's epoch.
* PATH B (no finetune): the loaded model (deploy state for reparam
  branches) is pruned and quantized as it is.
* QAT (``finetune_qat`` with quantization on): reparam branches deploy
  FIRST, then the finetune's forward runs on the fake-quantized deploy
  weights (compress/qat.py), so the final quantization is (near-)lossless.
* Quantization runs the JAX package's numpy ``quantize_state`` directly on
  the port's state dict: its names and layouts (OIHW, [out, in]) are the
  reference's, so per-output-channel grouping at ``quant_axis`` 0 is dim 0
  and no layout bridge is needed.  The dequantized state is loaded back
  into the model; its f32 values are the numpy ones, bit for bit.
* ``bitstream_path``: the ``.rnvb`` artifact and its all-in BPP come from
  the JAX package's numpy writer, fed the same (state, codes, qparams), so
  its decode equals the returned model's state bit-exactly.

Cast and rounding points the tests rely on: the state goes to numpy as
f32 and is quantized there (``np.round``, half to even), so the codes, the
report and the ``.rnvb`` bytes equal the JAX package's; QAT's fake
quantizer rounds half to even too (``torch.round``), in f32, with the
numpy expression's ``scale + 1e-19``.  The int8 decode's own points (a
division by the input scale in ``quantize_act_int8``, or in K1's epilogue
where the block before the first int8 block runs K1's wgmma route on the
card, with the same rounding; a multiplication by ``1/out_scale`` in the
stage, no FMA in its epilogue) are in ``kernels/decode_int8.py``.

Every stage leaves the caller's model alone: ``compress`` works on a copy.
"""

from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np
from torch import nn

from ..config import TrainConfig
from ..data.frames import FrameStore
from ..models.generator import Generator, generator_to_deploy
from ..train.checkpoint import load_state
from ..train.loop import (
    Masks,
    TrainState,
    make_epoch_fn,
    make_optimizer,
    make_streaming_epoch_fn,
    make_train_step,
    run_epoch,
    run_fused_epoch,
)
from .bitstream import all_in_bpp, write_bitstream
from .huffman import bits_per_pixel, entropy_stats
from .prune import apply_masks, global_l1_masks, verify_ratio
from .qat import make_fake_quant
from .quantize import quantize_state
from .rans import entropy_stats_rans


@dataclass
class CompressionReport:
    prune_ratio_requested: float = 1.0
    prune_ratio_actual: float = 0.0
    prune_ok: bool = True
    quant_bit: int = -1
    avg_bits: float = 0.0
    efficiency: float = 0.0
    total_bits: float = 0.0
    bpp: float = 0.0
    num_symbols: int = 0
    finetune_epochs: int = 0
    extras: Dict[str, Any] = field(default_factory=dict)


def prune_params(
    model: Generator, cfg: TrainConfig, report: CompressionReport
) -> Tuple[Generator, Masks]:
    """Global L1 prune of ``model`` in place; returns (model, masks)."""
    if cfg.prune_ratio >= 1.0:
        return model, None
    masks, actual = global_l1_masks(model, cfg.model.branch_type, cfg.prune_ratio)
    report.prune_ratio_requested = cfg.prune_ratio
    report.prune_ratio_actual = actual
    report.prune_ok = verify_ratio(actual, cfg.prune_ratio)
    return apply_masks(model, masks), masks


def finetune(
    model: Generator,
    masks: Masks,
    cfg: TrainConfig,
    store: FrameStore,
    report: CompressionReport,
    max_steps_per_epoch: Optional[int] = None,
    start_epoch: int = 0,
) -> Generator:
    """Masked finetuning of ``model`` in place with a fresh Adam
    (main_eval.py:405-417, 450-531); through the fake quantizer with
    ``finetune_qat``.  Returns the model in eval mode."""
    steps_per_epoch = max(store.num_samples // cfg.data.batch_size, 1)
    if cfg.finetune_lr_mode == "reference":
        ft_cfg = cfg  # the original epochs and warmup; the step counter carries the offset
        step0 = start_epoch * steps_per_epoch
    else:
        ft_cfg = dataclasses.replace(cfg, epochs=cfg.finetune_epochs)
        step0 = 0
    param_transform = None
    if cfg.finetune_qat and cfg.quant_bit != -1:
        param_transform = make_fake_quant(cfg.quant_bit, cfg.quant_axis)
        report.extras["qat"] = True
    model.train()
    state = TrainState(model, make_optimizer(cfg, model), step0)
    if cfg.fused_epoch and max_steps_per_epoch is None:
        maker = make_epoch_fn if store.resident else make_streaming_epoch_fn
        epoch_fn = maker(ft_cfg, steps_per_epoch, with_msssim=False,
                         param_transform=param_transform)
        for epoch in range(cfg.finetune_epochs):
            state, _ = run_fused_epoch(state, epoch_fn, store, ft_cfg, epoch, masks=masks)
    else:
        step = make_train_step(ft_cfg, steps_per_epoch, with_msssim=False,
                               param_transform=param_transform)
        for epoch in range(cfg.finetune_epochs):
            state, _ = run_epoch(state, step, store, ft_cfg, epoch, masks=masks,
                                 max_steps=max_steps_per_epoch)
    report.finetune_epochs = cfg.finetune_epochs
    return model.eval()


def model_state(model: nn.Module) -> Dict[str, np.ndarray]:
    """A copy of the model's state dict as f32 numpy arrays, in its own
    order (a copy: on the CPU ``.numpy()`` would alias the parameters)."""
    return {k: np.array(v.detach().cpu(), dtype=np.float32) for k, v in model.state_dict().items()}


def quantize_params(
    model: Generator,
    cfg: TrainConfig,
    report: CompressionReport,
    frame_hw=None,
    n_frames: int = 0,
    return_qdata: bool = False,
    skip_entropy: bool = False,
):
    """Quantize every tensor of ``model`` with the reference's grouping
    (``quantize_state`` on its state dict), gather the nonzero codes for the
    entropy statistics and BPP, and load the dequantized state back into
    ``model`` (in place).  With ``return_qdata`` also returns (state, codes,
    qparams) for ``write_bitstream``; ``skip_entropy`` leaves the statistics
    to the caller's one real encode."""
    if cfg.quant_bit == -1:
        return (model, None) if return_qdata else model
    state = model_state(model)
    dequant, all_codes, nonzero_codes, qparams = quantize_state(
        state, cfg.quant_bit, cfg.quant_axis
    )
    report.quant_bit = cfg.quant_bit
    if not skip_entropy:
        codes = np.concatenate(nonzero_codes) if nonzero_codes else np.zeros(0)
        if cfg.codec == "rans":
            stats = entropy_stats_rans(codes, cfg.quant_bit)
        else:
            stats = entropy_stats(codes, cfg.quant_bit)
        report.avg_bits = stats["avg_bits"]
        report.efficiency = stats["efficiency"]
        report.total_bits = stats["total_bits"]
        report.num_symbols = int(stats["num_symbols"])
        if frame_hw is not None and n_frames:
            report.bpp = bits_per_pixel(stats["total_bits"], n_frames, *frame_hw)
    load_state(model, dequant)
    if return_qdata:
        return model, (state, all_codes, qparams)
    return model


def compress(
    model: Generator,
    cfg: TrainConfig,
    store: Optional[FrameStore] = None,
    *,
    max_steps_per_epoch: Optional[int] = None,
    start_epoch: int = 0,
    bitstream_path: Optional[str] = None,
) -> Tuple[Generator, CompressionReport]:
    """The whole PATH A / B pipeline on a copy of ``model`` (train or deploy
    state, as the caller loaded it); returns (the compressed model, its
    branches fused for deploy, in eval mode, report).  ``start_epoch`` (the checkpoint's epoch) matters only
    for ``finetune_lr_mode="reference"``."""
    report = CompressionReport()
    qat = cfg.finetune and cfg.finetune_qat and cfg.quant_bit != -1
    model = copy.deepcopy(model)
    deploy = cfg.model.branch_type != "NeRV_vanilla" and not cfg.model.deploy
    if qat and deploy:
        model = generator_to_deploy(model)  # QAT trains the tensors the quantizer sees
        cfg = dataclasses.replace(cfg, model=model.cfg)
    model, masks = prune_params(model, cfg, report)
    if cfg.finetune and (cfg.prune_ratio < 1.0 or qat):
        if store is None:
            raise ValueError("finetune needs a frame store")
        model = finetune(model, masks, cfg, store, report, max_steps_per_epoch,
                         start_epoch=start_epoch)
    if deploy and not qat:
        model = generator_to_deploy(model)
    model.eval()
    hw = store.hw if store is not None else None
    n = store.frames.shape[0] if store is not None else 0
    write_bs = bool(bitstream_path) and cfg.quant_bit != -1
    model, qdata = quantize_params(model, cfg, report, frame_hw=hw, n_frames=n,
                                   return_qdata=True, skip_entropy=write_bs)
    if write_bs:
        deployed = any(blk.rbr_reparam is not None for blk in model.layers)
        mcfg = dataclasses.replace(cfg.model, deploy=cfg.model.deploy or deployed)
        acct = write_bitstream(bitstream_path, None, mcfg, cfg.quant_bit, cfg.quant_axis,
                               cfg.codec, precomputed=qdata)
        if hw is not None and n:
            acct["bpp_all_in"] = all_in_bpp(acct["file_bytes"], n, *hw)
        report.extras["bitstream"] = acct
        # the artifact's one encode is the entropy accounting: its payload
        # bits are what entropy_stats[_rans] would have measured
        report.total_bits = acct["payload_bits"]
        report.avg_bits = acct["payload_bits"] / max(acct["n_symbols"], 1.0)
        report.efficiency = report.avg_bits / cfg.quant_bit if cfg.quant_bit > 0 else 0.0
        report.num_symbols = int(acct["distinct_symbols"])
        if hw is not None and n:
            report.bpp = bits_per_pixel(acct["payload_bits"], n, *hw)
    return model, report

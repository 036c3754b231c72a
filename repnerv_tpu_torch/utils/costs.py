"""Analytic MAC count of the generator (port of the analytic part of
``repnerv_tpu/utils/costs.py``; thop conventions: conv MACs = k*k*Cin*Cout*H*W,
linear MACs = din*dout).  The JAX package's ``xla_cost_analysis`` asks XLA's
cost model and has no counterpart here (ROADMAP A9).
"""

from __future__ import annotations

from typing import Dict

from ..config import ModelConfig, head_plan, stage_channels


def generator_macs(cfg: ModelConfig, deploy: bool = True) -> Dict[str, float]:
    """Analytic per-frame MACs for the generator (thop conventions).

    ``deploy``: count the fused single 3x3 conv per block; else count every
    training branch (the reference profiles whatever graph is loaded).
    """
    h, w, c = cfg.fc_hwd
    stem_dim, stem_num = cfg.stem_dims
    macs = 0.0
    dims = [cfg.embed_length] + [stem_dim] * stem_num + [h * w * c]
    for a, b in zip(dims[:-1], dims[1:]):
        macs += a * b

    sh, sw = h, w
    plan = stage_channels(cfg)
    for ngf, new_ngf, stride in plan:
        cout = new_ngf * stride * stride
        if deploy or cfg.branch_type == "NeRV_vanilla":
            macs += 9 * ngf * cout * sh * sw
        elif cfg.branch_type == "ERB":
            macs += (9 + 3 + 3) * ngf * cout * sh * sw
            macs += (ngf * 2 * ngf + 9 * 2 * ngf * cout + cout * cout) * sh * sw
        elif cfg.branch_type == "ACB":
            macs += (9 + 3 + 3) * ngf * cout * sh * sw
        elif cfg.branch_type == "RepVGG":
            macs += (9 + 1) * ngf * cout * sh * sw
        elif cfg.branch_type == "DBB":
            macs += (9 + 1) * ngf * cout * sh * sw
            macs += (ngf * 2 * ngf + 9 * 2 * ngf * cout) * sh * sw
            macs += (ngf * cout + 9 * cout) * sh * sw
        elif cfg.branch_type == "ECB":
            macs += 9 * ngf * cout * sh * sw
            macs += (ngf * 2 * ngf + 9 * 2 * ngf * cout) * sh * sw
            macs += 3 * (ngf * cout + 9 * cout) * sh * sw
        sh, sw = sh * stride, sw * stride

    heads = head_plan(cfg)
    hh, ww = h, w
    for i, stride in enumerate(cfg.strides):
        hh, ww = hh * stride, ww * stride
        stage_out = plan[(i + 1) * cfg.num_blocks - 1][1]
        if heads[i]:
            macs += stage_out * 3 * hh * ww
    return {"macs": macs, "flops": 2 * macs}

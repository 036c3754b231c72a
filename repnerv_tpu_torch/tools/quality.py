"""The paper's quality numbers on the card, through the port's own CLIs.

    python -m repnerv_tpu_torch.tools.quality --work DIR --out summary.json \\
        [--runs a b c d] [--seed 1] [--extra='FLAGS'] [--stop_epoch N] \\
        [--repeats K] [--tag NAME]

The recipe is the JAX package's flagship `-b 1` run (its README quick start
on the 132-frame 720p synthetic video, ``--dataset synth``): 300 epochs,
bf16, Fusion6, cosine with 20% warm-up, a checkpoint and an evaluation every
25 epochs.  The runs, each one process of the port's CLI:

* ``a``: ``train_main`` on the ERB generator (``--manualSeed``, default 1);
* ``b``: the same with ``--branch_type NeRV_vanilla``;
* ``c``: ``eval_main`` on a's run: PATH B (prune 0.2, 8 bits, ``.rnvb``
  checked bit-exactly) and PATH A (the same after a 10-epoch masked
  finetune);
* ``d``: ``eval_main`` on a's deployed weights, unpruned: the int8 decode
  from block -2 against bf16 on the same weights.

``--extra`` adds flags to every train run (``--no_pallas_train``,
``--compute_dtype float32``: the ladder that localizes a miss);
``--stop_epoch N`` stops each train run after epoch N of the schedule
(``--repeats K`` runs it K times in fresh directories: the spread of a
short check).  Per train run the summary holds the train PSNR / MS-SSIM of
every epoch, the val PSNR / MS-SSIM of every evaluation, the wall and the
seconds per epoch; per eval run its result line (PSNR, MS-SSIM, BPP,
entropy-coding efficiency, fps).  Each process's output goes to a log file
under ``--work``; one summary line per run goes to stdout.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

RECIPE = (
    "--dataset synth --synthetic_frames 132 --synthetic_hw 720 1280 "
    "--embed 1.25_40 --stem_dim_num 512_1 --fc_hw_dim 9_16_26 --expansion 1 "
    "--reduction 2 --num_blocks 1 --strides 5 2 2 2 2 --lower_width 96 --norm none "
    "--conv_type conv --act swish --single_res --loss Fusion6 -b 1 --lr 0.0005 "
    "--warmup 0.2 --lr_type cosine -e 300 --compute_dtype bfloat16 "
    "--ckpt_freq 25 --eval_freq 25"
).split()
PATH_B = "--prune_ratio 0.2 --quant_bit 8 --save_bitstream".split()
PATH_A = PATH_B + "--finetune --finetune_epochs 10".split()
INT8 = "--decode_int8 --int8_from_block -2".split()

_EPOCH = re.compile(r"Epoch\[(\d+)/\d+\] lr:(\S+) PSNR: (\S+) MSSSIM: (\S+) "
                    r"Time/epoch: Current:(\S+) Average:(\S+)")
_EVAL = re.compile(r"Eval at epoch (\d+): PSNR (\S+) MSSSIM (\S+)")


def _last(row: str) -> float:
    return float(row.split(",")[-1])


def parse_rank0(path: str) -> dict:
    """The train and eval lines of a ``rank0.txt``: per epoch (lr, train
    PSNR and MS-SSIM of the last stage, seconds), per evaluation (val PSNR
    and MS-SSIM of the last stage)."""
    epochs, evals = {}, {}
    with open(path) as f:
        for line in f:
            m = _EPOCH.search(line)
            if m:
                epochs[int(m[1])] = {"lr": float(m[2]), "psnr": _last(m[3]),
                                     "msssim": _last(m[4]), "s": float(m[5])}
            m = _EVAL.search(line)
            if m:
                evals[int(m[1])] = {"psnr": _last(m[2]), "msssim": _last(m[3])}
    return {"epochs": epochs, "evals": evals}


def _run(cmd: list, log_path: str) -> float:
    """Run ``cmd`` with its output in ``log_path``; its wall seconds.  A
    failed run raises with the log's tail."""
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        rc = subprocess.run(cmd, stdout=log, stderr=subprocess.STDOUT).returncode
    wall = time.perf_counter() - t0
    if rc:
        with open(log_path) as f:
            tail = f.read()[-3000:]
        raise RuntimeError(f"{' '.join(cmd[:4])} ... exited {rc}:\n{tail}")
    return wall


def train(work: str, name: str, branch: str, seed: int, extra: list, stop_epoch: int = 0) -> dict:
    argv = RECIPE + ["--branch_type", branch, "--manualSeed", str(seed), "--outf", work,
                     "--suffix", name] + extra
    stop = ["--stop_epoch", str(stop_epoch)] if stop_epoch else []
    outf = os.path.join("result", work, name)
    wall = _run([sys.executable, "-m", "repnerv_tpu_torch.cli.train_main"] + argv + stop,
                os.path.join("result", work, f"{name}.log"))
    got = parse_rank0(os.path.join(outf, "rank0.txt"))
    steady = [e["s"] for k, e in got["epochs"].items() if k > 1]
    return {"argv": argv, "outf": outf, "wall_s": wall,
            "s_per_epoch": sum(steady) / max(len(steady), 1), **got}


def evaluate(work: str, name: str, run: dict, extra: list) -> dict:
    """One ``eval_main`` process on a train run's directory; its result line
    (the last line of the result file it appended to, the newest)."""
    outf = run["outf"]
    wall = _run([sys.executable, "-m", "repnerv_tpu_torch.cli.eval_main"] + run["argv"] + extra,
                os.path.join("result", work, f"{name}.log"))
    results = [f for f in os.listdir(outf) if f.endswith(".txt") and f != "rank0.txt"]
    newest = max(results, key=lambda f: os.path.getmtime(os.path.join(outf, f)))
    with open(os.path.join(outf, newest)) as f:
        res = json.loads(f.read().strip().splitlines()[-1])
    return {"argv": extra, "wall_s": wall, "psnr": res["val_psnr"][-1],
            "msssim": res["val_msssim"][-1], **res}


def smi() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip()
    except OSError as e:
        return f"nvidia-smi not run ({e})"


def _say(name: str, r: dict) -> None:
    if "epochs" in r:
        ev = ", ".join(f"{k}: {v['psnr']:.2f} / {v['msssim']:.4f}"
                       for k, v in sorted(r["evals"].items()))
        last = max(r["epochs"])
        print(f"[quality] {name}: {last} epochs in {r['wall_s']:.1f} s "
              f"({r['s_per_epoch']:.3f} s an epoch); train PSNR at {last} "
              f"{r['epochs'][last]['psnr']:.4f}; val PSNR / MS-SSIM {ev}", flush=True)
    else:
        print(f"[quality] {name}: PSNR {r['psnr']:.4f} MS-SSIM {r['msssim']:.4f} "
              f"BPP {r['bpp']:.6f} efficiency {r['efficiency']} fps {r['fps']:.2f} "
              f"in {r['wall_s']:.1f} s", flush=True)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--work", required=True, help="--outf of the runs (under result/)")
    p.add_argument("--out", required=True, help="summary JSON")
    p.add_argument("--runs", nargs="+", default=["a", "b", "c", "d"])
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--extra", default="", help="flags for every train run, one string: "
                   "--extra='--no_pallas_train'")
    p.add_argument("--stop_epoch", type=int, default=0)
    p.add_argument("--repeats", type=int, default=1)
    p.add_argument("--tag", default="", help="names the runs (default s<seed>)")
    a = p.parse_args(argv)
    a.extra = a.extra.split()
    os.makedirs(os.path.join("result", a.work), exist_ok=True)
    summary = {"smi": smi(), "seed": a.seed, "extra": a.extra, "runs": {}}
    print(f"[quality] nvidia-smi: {summary['smi']}", flush=True)
    runs = summary["runs"]

    def record(name, r):
        runs[name] = r
        _say(name, r)
        with open(a.out, "w") as f:
            json.dump(summary, f)

    tag = a.tag or f"s{a.seed}"
    for key, branch in (("a", "ERB"), ("b", "NeRV_vanilla")):
        if key not in a.runs:
            continue
        for i in range(a.repeats):
            name = f"{key}_{tag}" + (f"_r{i}" if a.repeats > 1 else "")
            record(name, train(a.work, name, branch, a.seed, a.extra, a.stop_epoch))
    erb = runs.get(f"a_{tag}")
    if erb is not None and "c" in a.runs:
        record("c_path_b", evaluate(a.work, "c_path_b", erb, PATH_B))
        record("c_path_a", evaluate(a.work, "c_path_a", erb, PATH_A))
    if erb is not None and "d" in a.runs:
        record("d_bf16", evaluate(a.work, "d_bf16", erb, []))
        record("d_int8", evaluate(a.work, "d_int8", erb, INT8))
        print(f"[quality] d: int8 from block -2 minus bf16 on the same weights "
              f"{runs['d_int8']['psnr'] - runs['d_bf16']['psnr']:+.4f} dB", flush=True)
    return summary


if __name__ == "__main__":
    main()

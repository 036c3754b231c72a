"""Program spans of the port (``repnerv_tpu_torch/utils/profiling.py``:
``span``, ``capture_graph``, ``Labels``, ``trace``'s summary by span,
``last_trace``).

* A span with no trace open and no graph being captured does nothing and
  makes no ``record_function``.
* Inside ``trace(dir, "cpu")`` spans nest, count and take their host time
  in ``Trace.spans``; ``last_trace()`` hands the block's ``Trace`` back.
* The eager CPU step (``build_train_step_fn``) opens ``step.forward``,
  ``step.loss``, ``step.backward``, ``step.adam`` and ``step.metrics`` once
  each, with ``reparam.fuse`` inside ``step.forward`` once a block.
* ``summarize`` on hand-built chrome-trace events: a replay's ops charged by
  position to the label table's ranges, a replay whose op count differs
  from the table's left unattributed, eager ops charged through their
  launch by correlation id (autograd's thread through the main thread's
  span), idle gaps charged through the next launch on the host's clock,
  the same whatever the device clock's offset.

The ``gpu`` tests skip here and run on the card with
    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_spans.py
"""

import time

import pytest
import torch

from repnerv_tpu_torch.config import DataConfig, ModelConfig, TrainConfig
from repnerv_tpu_torch.data.frames import synthetic_video
from repnerv_tpu_torch.train import loop
from repnerv_tpu_torch.utils import profiling
from repnerv_tpu_torch.utils.profiling import GraphLabels, Labels, span, summarize, trace

TINY = ModelConfig(embed="1.25_4", stem_dim_num="16_1", fc_hw_dim="3_4_6", strides=(2, 2),
                   lower_width=4, branch_type="ERB")
STEP_SPANS = ("step.forward", "step.loss", "step.backward", "step.adam", "step.metrics")


def test_a_span_off_records_nothing(monkeypatch):
    made = []
    monkeypatch.setattr(profiling, "record_function", lambda name: made.append(name))
    assert not profiling._ON
    ctx = span("step.forward")
    assert ctx is profiling._OFF  # one shared object: nothing is made
    with ctx, span("inner"):
        torch.ones(3).sum()
    assert made == []


def test_spans_nest_count_and_time_in_a_cpu_trace(tmp_path):
    with trace(str(tmp_path), "cpu") as rec:
        for _ in range(3):
            with span("outer"):
                time.sleep(0.002)
                with span("inner"):
                    time.sleep(0.003)
        with span("inner"):  # the same name elsewhere is another path
            pass
    assert not profiling._ON  # off again after the block
    assert profiling.last_trace() is rec
    outer, inner = rec.spans["outer"], rec.spans["outer/inner"]
    assert outer.count == inner.count == 3 and rec.spans["inner"].count == 1
    assert inner.host_s >= 0.009 and inner.self_s == inner.host_s
    assert outer.host_s >= inner.host_s + 0.006
    assert outer.self_s == pytest.approx(outer.host_s - inner.host_s, abs=1e-9)
    assert outer.device_s == inner.device_s == 0.0 and rec.idle == {}
    assert rec.unattributed == []


def test_the_eager_cpu_step_opens_each_step_span_once(tmp_path):
    cfg = TrainConfig(model=TINY, data=DataConfig(batch_size=1), epochs=2, lr=5e-3,
                      loss_type="Fusion6")
    video, t = synthetic_video(2, 12, 16, seed=2)
    frames, t = torch.from_numpy(video[:1]), torch.from_numpy(t[:1])
    state = loop.init_train_state(cfg, "cpu", seed=0)
    step = loop.build_train_step_fn(cfg, 2, with_msssim=False)
    with trace(str(tmp_path), "cpu") as rec:
        step(state, frames, t)
    top = {p: s.count for p, s in rec.spans.items() if "/" not in p}
    assert top == dict.fromkeys(STEP_SPANS, 1)
    assert rec.spans["step.forward/reparam.fuse"].count == len(TINY.strides)
    assert rec.spans["step.backward"].host_s > 0
    assert rec.spans["step.adam/Optimizer.step#Adam.step"].count == 1  # torch's own range


# ---------------------------------------------------------------------------
# summarize on hand-built events (ts and dur in microseconds, as kineto's)
# ---------------------------------------------------------------------------

MAIN, AUTOGRAD = (1, 10), (1, 11)


def _host(name, ts, dur, thread=MAIN):
    return {"ph": "X", "cat": "user_annotation", "name": name, "pid": thread[0],
            "tid": thread[1], "ts": ts, "dur": dur}


def _launch(name, ts, dur, corr, thread=MAIN):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "pid": thread[0], "tid": thread[1],
            "ts": ts, "dur": dur, "args": {"correlation": corr}}


def _op(ts, dur, corr, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": f"k{corr}", "pid": 0, "tid": 7, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def _table(nodes=4):
    lab = Labels("test")
    lab.graphs.append(GraphLabels(nodes=nodes, ranges=[("a/b", 1, 2), ("a", 0, 2),
                                                       ("c", 2, 4)]))
    return lab


def _replay_events(lab, n_ops, offset):
    """A replay span around one cudaGraphLaunch whose ops the card runs
    ``offset`` us away from the host's clock."""
    return [_host("req", 0, 300), _host(lab.span, 100, 50),
            _launch("cudaGraphLaunch", 110, 10, 7),
            *[_op(offset + 200 + 20 * k, 10, 7, "gpu_memset" if k == 3 else "kernel")
              for k in range(n_ops)]]


def _named_replay(names):
    """One replay of a 4-op graph whose op 1 is a kernel named "fold"
    (``name_node``), the ops starting in the order of ``names``."""
    lab = Labels("test")
    lab.graphs.append(GraphLabels(nodes=4, ranges=[("a", 0, 1), ("a/f", 1, 2), ("c", 2, 4)],
                                  named={"fold": [1]}))
    events = [_host("req", 0, 300), _host(lab.span, 100, 50),
              _launch("cudaGraphLaunch", 110, 10, 7)]
    for k, name in enumerate(names):
        events.append({**_op(200 + 20 * k, 10 + k, 7), "name": name})
    return lab, events


@pytest.mark.parametrize("names", [("x", "void fold<2>(P)", "y", "z"),
                                   ("void fold<2>(P)", "x", "y", "z"),
                                   ("x", "y", "z", "void fold<2>(P)")])
def test_a_named_kernel_on_its_own_stream_keeps_its_span(names):
    """The fold, captured as op 1 on a stream of its own, starts anywhere
    in the replay: it goes to ``a/f``, and the other ops, in their own
    start order, to ops 0, 2 and 3."""
    lab, events = _named_replay(names)
    spans, _, unattributed = summarize(events, {lab.id: lab})
    base = f"req/{lab.span}"
    assert unattributed == []
    dur = {name: 10 + k for k, name in enumerate(names)}
    assert {p: round(s.device_s * 1e6) for p, s in spans.items() if s.ops} == {
        f"{base}/a": dur["x"], f"{base}/a/f": dur["void fold<2>(P)"],
        f"{base}/c": dur["y"] + dur["z"]}


def test_a_named_kernels_count_mismatch_leaves_the_graph_unattributed():
    lab, events = _named_replay(("x", "void fold<2>(P)", "void fold<2>(P)", "z"))
    assert summarize(events, {lab.id: lab})[2] == [lab.id]
    lab, events = _named_replay(("x", "y", "w", "z"))
    assert summarize(events, {lab.id: lab})[2] == [lab.id]


@pytest.mark.parametrize("offset", [0.0, 7000.0, -5000.0])
def test_replayed_ops_are_charged_by_position(offset):
    lab = _table()
    spans, idle, unattributed = summarize(_replay_events(lab, 4, offset), {lab.id: lab})
    base = f"req/{lab.span}"
    assert unattributed == []
    assert {p: (s.ops, round(s.device_s * 1e6)) for p, s in spans.items() if s.ops} == {
        f"{base}/a": (1, 10), f"{base}/a/b": (1, 10), f"{base}/c": (2, 20)}
    assert spans[f"{base}/a"].count == spans[f"{base}/c"].count == 1
    assert spans[f"{base}/a"].host_s == 0.0 and spans[base].count == 1
    # the gaps inside the replay (10 us before ops 1-3) go to the op after them
    assert {p: round(s * 1e6) for p, s in idle.items()} == {
        f"{base}/a/b": 10, f"{base}/c": 20}


def test_a_count_mismatch_leaves_the_graph_unattributed():
    lab = _table()
    spans, idle, unattributed = summarize(_replay_events(lab, 3, 0.0), {lab.id: lab})
    assert unattributed == [lab.id]
    assert {p: s.ops for p, s in spans.items() if s.ops} == {f"req/{lab.span}": 3}
    # a table with another number of graphs than the span's launches: the same
    lab2 = _table()
    lab2.graphs.append(GraphLabels(nodes=0))
    assert summarize(_replay_events(lab2, 4, 0.0), {lab2.id: lab2})[2] == [lab2.id]
    # no table of that id (it died): never guessed
    assert summarize(_replay_events(lab, 4, 0.0), {})[2] == [lab.id]


@pytest.mark.parametrize("offset", [0.0, 6000.0])
def test_eager_ops_are_charged_through_their_launch(offset):
    events = [_host("s", 0, 100), _host("k", 20, 40),
              _launch("cudaLaunchKernel", 30, 5, 1), _launch("cudaLaunchKernel", 70, 5, 2),
              _launch("cudaLaunchKernel", 40, 5, 3, thread=AUTOGRAD),
              _launch("cudaMemcpyAsync", 80, 5, 4),
              _op(offset + 31, 3, 1), _op(offset + 200, 4, 2), _op(offset + 50, 2, 3),
              _op(offset + 300, 1, 4, "gpu_memcpy"), _op(offset + 400, 1, 99)]
    spans, _, unattributed = summarize(events, {})
    assert {p: s.ops for p, s in spans.items() if s.ops} == {"s/k": 2, "s": 2, "": 1}
    assert round(spans["s/k"].device_s * 1e6) == 5 and round(spans["s"].device_s * 1e6) == 5
    assert spans["s"].count == spans["s/k"].count == 1 and unattributed == []


@pytest.mark.parametrize("offset", [0.0, 8000.0, -3000.0])
def test_idle_gaps_are_charged_through_the_next_launch(offset):
    """Ops A and B, 40 us apart on the card; B's launch ends at 205 us,
    inside ``req/p`` (150-210), so the gap lies over 165-205 of the host:
    all of it in ``req/p``.  C follows B after 80 us; its launch ends at 290,
    so its gap lies over 210-290: 70 us in ``req`` (to 280) and 10 in no
    span."""
    events = [_host("req", 100, 180), _host("p", 150, 60),
              _launch("cudaLaunchKernel", 20, 5, 1), _launch("cudaLaunchKernel", 200, 5, 2),
              _launch("cudaLaunchKernel", 285, 5, 3),
              _op(offset + 1000, 10, 1), _op(offset + 1050, 10, 2), _op(offset + 1140, 5, 3)]
    _, idle, _ = summarize(events, {})
    assert {p: round(s * 1e6) for p, s in idle.items()} == {"req/p": 40, "req": 70, "": 10}


def test_a_replays_first_op_takes_its_gap_through_the_graph_launch():
    lab = _table()
    events = _replay_events(lab, 4, 500.0) + [_host("prep", 20, 70),
                                              _launch("cudaLaunchKernel", 5, 3, 1),
                                              _op(600.0, 10, 1)]
    # the eager op ends at 610; the replay's first op starts at 700: 90 us,
    # laid over 30-120 (the graph launch ends at 120)
    _, idle, _ = summarize(events, {lab.id: lab})
    got = {p: round(s * 1e6) for p, s in idle.items()}
    assert got["req/prep"] == 60 and got["req"] == 10 and got[f"req/{lab.span}"] == 20


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graph capture and CUPTI's kernel events")


@pytest.mark.gpu
def test_a_captured_graph_charges_each_kernel_to_its_span(tmp_path):
    _cuda()
    dev = torch.device("cuda")
    x = torch.zeros(1 << 20, device=dev)
    y = torch.zeros_like(x)

    def body():
        with span("one"):
            x.add_(1.0)
            x.mul_(2.0)
        y.copy_(x)  # outside every span
        with span("two"):
            with span("inner"):
                y.sub_(x)
            y.fill_(3.0)

    def capture(side):
        g = torch.cuda.CUDAGraph()
        with profiling.capture_graph(g, side):
            body()
        return g

    graph, _, labels = loop.capture_after_eager(dev, body, capture, "test")
    (g,) = labels.graphs
    assert g.nodes == 5 and sorted(g.ranges) == [("one", 0, 2), ("two", 3, 5),
                                                 ("two/inner", 3, 4)]
    with trace(str(tmp_path), dev) as rec:
        for _ in range(3):
            with span(labels.span):
                graph.replay()
    assert rec.unattributed == []
    ops = {p.split(labels.span + "/")[-1]: s.ops for p, s in rec.spans.items()
           if labels.span in p and s.ops}
    assert ops == {"one": 6, "two": 3, "two/inner": 3, labels.span: 3}
    assert rec.spans[f"{labels.span}/one"].count == 3
    assert all(s.device_s > 0 for p, s in rec.spans.items() if s.ops)


def _flagship_cfg() -> TrainConfig:
    from repnerv_tpu_torch.cli.args import args_to_config, build_parser

    argv = ("--dataset synth --synthetic_frames 4 --synthetic_hw 720 1280 --embed 1.25_40 "
            "--stem_dim_num 512_1 --fc_hw_dim 9_16_26 --expansion 1 --reduction 2 "
            "--num_blocks 1 --strides 5 2 2 2 2 --lower_width 96 --norm none --conv_type conv "
            "--act swish --single_res --loss Fusion6 -b 1 --lr 0.0005 --warmup 0.2 "
            "--lr_type cosine -e 300 --compute_dtype bfloat16 --branch_type ERB").split()
    return args_to_config(build_parser(eval_mode=False).parse_args(argv), eval_mode=False)


def _top_ops(rec, below=""):
    """Device ops by top-level step span (under ``below``), children in."""
    out = {}
    for path, s in rec.spans.items():
        rest = path[len(below):] if path.startswith(below) else None
        if rest is None or not s.ops:
            continue
        top = rest.split("/")[0]
        if top in STEP_SPANS:
            out[top] = out.get(top, 0) + s.ops
    return out


@pytest.mark.gpu
def test_the_replayed_flagship_step_matches_the_eager_step_span_by_span(tmp_path):
    """The erb-720p bf16 step: each top-level span's ops in a replay of
    ``make_train_step``'s graph equal the same span's in an eager traced step
    of ``build_train_step_fn``, but for the graph step's copies of the loss,
    PSNR and MS-SSIM into its buffers (``step.metrics``)."""
    _cuda()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _flagship_cfg()
    video, t = synthetic_video(2, 720, 1280, seed=3)
    frames, t = torch.from_numpy(video[:1]).cuda(), torch.from_numpy(t[:1]).cuda()
    state = loop.init_train_state(cfg, "cuda", seed=0)
    eager = loop.build_train_step_fn(cfg, 2, with_msssim=True)
    eager(state, frames, t)  # builds the kernels, makes Adam's state
    with trace(str(tmp_path / "eager"), "cuda") as eager_rec:
        eager(state, frames, t)
    graph = loop.make_train_step(cfg, 2, with_msssim=True)
    graph(state, frames, t)  # eager on a side stream, then the capture
    with trace(str(tmp_path / "graph"), "cuda") as rec:
        graph(state, frames, t)
    assert rec.unattributed == []
    (g,) = graph.labels.graphs
    replay = next(p for p in rec.spans if p.endswith(graph.labels.span))
    assert rec.spans[replay].count == 1 and sum(
        s.ops for p, s in rec.spans.items() if p.startswith(replay)) == g.nodes
    want = _top_ops(eager_rec)
    want["step.metrics"] += 3  # the graph step's index_copy_ into loss, psnr, msssim
    assert _top_ops(rec, replay + "/") == want
    covered = sum(s.device_s for p, s in rec.spans.items() if p.startswith(replay + "/"))
    assert covered >= 0.99 * sum(s.device_s for p, s in rec.spans.items()
                                 if p.startswith(replay))

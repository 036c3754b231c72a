"""Host ms a request from entry into ``VideoDecode.__call__`` to its
replay (span ``decode.prepare``: the buffers, the copy of t, the frames'
allocation and ``decode_graph_key``).

A traced host reading: it is taken with ``torch.profiler`` on, which
records every ATen op inside the span and the nested ``decode.key`` range,
so it reads more than an untraced request pays.  PERF.md §6 gives the
untraced time beside it; compare a change with this reading only against
the same reading of its parent."""

from harness.spans import host_s, per


def read(ctx):
    return per(ctx, "decode", host_s("decode.prepare"))

"""Minimal XSpace (.xplane.pb) parser: per-op device-time summary.

``jax.profiler.trace`` writes device timings as an XSpace protobuf.
This hand-rolled wire-format parser needs no protobuf package: it
extracts what kernel work costs on the GPU, every XEvent on the
``/device:GPU:<n>`` planes, aggregated by event name.

Usage:
  python tools/parse_xplane.py <trace_dir_or_xplane.pb> [top_n]

(Proto schema: tensorflow/compiler/xla/backends/profiler — XSpace.planes
= 1; XPlane{name=2, lines=3, event_metadata=4}; XLine{events=4};
XEvent{metadata_id=1, duration_ps=3}; XEventMetadata{id=1, name=2,
display_name=4}.)
"""
from __future__ import annotations

import glob
import sys
from collections import defaultdict


def _varint(buf: bytes, i: int):
    x = 0
    s = 0
    while True:
        b = buf[i]
        i += 1
        x |= (b & 0x7F) << s
        if not b & 0x80:
            return x, i
        s += 7


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a message buffer."""
    i = 0
    n = len(buf)
    while i < n:
        tag, i = _varint(buf, i)
        fno, wt = tag >> 3, tag & 7
        if wt == 0:
            v, i = _varint(buf, i)
        elif wt == 2:
            ln, i = _varint(buf, i)
            v = buf[i:i + ln]
            i += ln
        elif wt == 5:
            v = buf[i:i + 4]
            i += 4
        elif wt == 1:
            v = buf[i:i + 8]
            i += 8
        else:
            raise ValueError(f"wire type {wt}")
        yield fno, wt, v


def parse_plane(buf: bytes):
    name = ""
    lines = []
    meta = {}
    for fno, wt, v in _fields(buf):
        if fno == 2 and wt == 2:
            name = v.decode(errors="replace")
        elif fno == 3 and wt == 2:
            lines.append(v)
        elif fno == 4 and wt == 2:
            # map entry {key=1, value=2:XEventMetadata}
            mid, mname = None, ""
            for f2, w2, v2 in _fields(v):
                if f2 == 2 and w2 == 2:
                    for f3, w3, v3 in _fields(v2):
                        if f3 == 1 and w3 == 0:
                            mid = v3
                        elif f3 == 2 and w3 == 2:
                            mname = v3.decode(errors="replace")
            if mid is not None:
                meta[mid] = mname
    return name, lines, meta


def summarize(path: str, top_n: int = 30):
    if not path.endswith(".pb"):
        cands = glob.glob(path + "/**/*.xplane.pb", recursive=True)
        if not cands:
            raise FileNotFoundError(f"no .xplane.pb under {path}")
        path = sorted(cands)[-1]
    buf = open(path, "rb").read()
    out = []
    for fno, wt, v in _fields(buf):
        if fno != 1 or wt != 2:
            continue
        pname, lines, meta = parse_plane(v)
        if not pname.startswith("/device:GPU:"):
            continue
        per_op = defaultdict(lambda: [0, 0])  # name -> [total_ps, count]
        for line in lines:
            for f2, w2, v2 in _fields(line):
                if f2 != 4 or w2 != 2:
                    continue
                mid, dur = None, 0
                for f3, w3, v3 in _fields(v2):
                    if f3 == 1 and w3 == 0:
                        mid = v3
                    elif f3 == 3 and w3 == 0:
                        dur = v3
                nm = meta.get(mid, f"op{mid}")
                per_op[nm][0] += dur
                per_op[nm][1] += 1
        if per_op:
            out.append((pname, per_op))
    for pname, per_op in out:
        total = sum(t for t, _ in per_op.values())
        print(f"== {pname}  (total {total/1e9:.3f} ms across lines) ==")
        rows = sorted(per_op.items(), key=lambda kv: -kv[1][0])[:top_n]
        for nm, (t, c) in rows:
            print(f"  {t/1e9:9.3f} ms  x{c:<6d} {nm[:110]}")
    return out


if __name__ == "__main__":
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    summarize(sys.argv[1], int(sys.argv[2]) if len(sys.argv) > 2 else 30)

"""Chrome trace-event export of the span tracer's ring buffer.

Counterpart of ``paddle_tpu/observe/timeline.py`` (reference
``tools/timeline.py``, which parses the CUPTI ``profiler.proto`` dump and
emits chrome://tracing JSON).  ``chrome_trace()`` renders the live
in-process buffer
(``observe/tracer.py``) directly into the Trace Event Format
(``ph: "X"`` complete events, microsecond timestamps), one lane per
thread, loadable in Perfetto (https://ui.perfetto.dev) or
chrome://tracing.

CLI (no code changes needed to trace any script)::

    python -m paddle_tpu_torch.observe.timeline out.json train.py --epochs 1

runs ``train.py`` under ``FLAGS_enable_tracer=1`` and writes the trace
on exit (including exceptional exit — the partial trace is exactly what
you want when debugging a hang/crash).  With no script argument it
dumps the current process's buffer (useful from a REPL or atexit hook).
"""
from __future__ import annotations

import json
from typing import List, Optional

from . import tracer as _tracer

__all__ = ["chrome_trace", "export_chrome_trace", "main"]


def chrome_trace(records: Optional[List] = None) -> dict:
    """Trace Event Format dict for ``records`` (default: the live
    buffer).  Spans become ``X`` (complete) events; thread lanes get
    ``M`` (metadata) names so Perfetto labels them."""
    t = _tracer.get_tracer()
    if records is None:
        records = t.snapshot()
    pid = t.pid
    events = [{
        "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
        "args": {"name": "paddle_tpu"},
    }]
    seen_tids = {}
    for r in records:
        if r.tid not in seen_tids:
            seen_tids[r.tid] = r.thread_name
            events.append({
                "name": "thread_name", "ph": "M", "pid": pid,
                "tid": r.tid, "args": {"name": r.thread_name},
            })
        ev = {
            "name": r.name,
            "cat": r.name.split("/", 1)[0],
            "ph": "X",
            "pid": pid,
            "tid": r.tid,
            "ts": round(r.t_begin * 1e6, 3),
            "dur": round((r.t_end - r.t_begin) * 1e6, 3),
        }
        args = dict(r.args or {})
        if r.parent is not None:
            args.setdefault("parent", r.parent)
        if args:
            ev["args"] = args
        events.append(ev)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "source": "paddle_tpu.observe",
            "spans": len(records),
            "dropped_spans": t.dropped,
        },
    }


def export_chrome_trace(path: Optional[str] = None,
                        records: Optional[List] = None):
    """Write the trace JSON to ``path`` (or return the dict when
    ``path`` is None)."""
    doc = chrome_trace(records)
    if path is None:
        return doc
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def main(argv: Optional[List[str]] = None) -> int:
    import runpy
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m paddle_tpu_torch.observe.timeline OUT.json "
              "[script.py [args...]]\n"
              "  With a script: run it under FLAGS_enable_tracer=1 and "
              "write the Chrome trace to OUT.json on exit.\n"
              "  Without: dump this process's current span buffer.",
              file=sys.stderr)
        return 0 if argv else 2
    out, rest = argv[0], argv[1:]
    if not rest:
        export_chrome_trace(out)
        print(f"wrote {out} "
              f"({len(_tracer.snapshot())} spans)", file=sys.stderr)
        return 0
    from ..framework import flags as _flags

    _flags.set_flags({"enable_tracer": True})
    script, script_args = rest[0], rest[1:]
    old_argv = sys.argv
    sys.argv = [script] + script_args
    try:
        runpy.run_path(script, run_name="__main__")
    finally:
        sys.argv = old_argv
        export_chrome_trace(out)
        print(f"wrote {out} ({len(_tracer.snapshot())} spans)",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

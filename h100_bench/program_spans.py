"""Run one cell as ``h100_bench.run`` does, with the program's span
recorder (``vda_tpu_torch/utils/trace.py``) open around the cell's window,
and print its result line with the program's metrics added
(``program_readers.METRICS``, under the cell's prefix).

    python3 -m h100_bench.program_spans --workload vitl.offline_720p \\
        --seed 7 --seconds 30 --trace 1

The arguments are ``h100_bench.run``'s; ``python3 -m h100_bench.run`` with
the same arguments is the run without the recorder, so the two in turns in
one call give its cost.  With ``--trace 1`` the line holds the cell's
per-layer metrics beside the program's, from the same window; the
profiler's breakdown then names the idle gaps by the program's spans too.
The benchmark's command itself does not open the recorder yet: once
``session.py`` opens it around ``driver.window`` (PERF.md, Open
questions), this module and its test go.
"""

from __future__ import annotations

import contextlib
import importlib

from h100_bench import program_readers, run, session


@contextlib.contextmanager
def _recorded(prog: dict):
    """``session.run_cell`` with the driver's window recorded: the
    snapshot goes to ``prog`` and its metrics, read beside the driver's
    wall time of the window, into the result."""
    from vda_tpu_torch.utils import trace

    run_cell = session.run_cell

    def recorded_cell(cell, *args, **kwargs):
        driver = importlib.import_module("h100_bench.drivers."
                                         + cell.traffic["driver"])
        window = driver.window

        def recorded_window(ctx, st):
            with trace.recording() as rec:
                window(ctx, st)
            prog.update(rec.snapshot())
            record["wall_s"] = st.wall

        record = {"program": prog}
        driver.window = recorded_window
        try:
            result, lines = run_cell(cell, *args, **kwargs)
        finally:
            driver.window = window
        prefix = cell.per_layer[0]["name"].split(".")[0]
        result["metrics"].update(program_readers.metrics(
            record, cell.traffic["driver"], prefix))
        return result, lines

    session.run_cell = recorded_cell
    try:
        yield
    finally:
        session.run_cell = run_cell


def main(argv=None) -> int:
    with _recorded({}):
        return run.main(argv)


if __name__ == "__main__":
    raise SystemExit(main())

"""Dry-run sweep over every (arch x shape x mesh) cell, one subprocess per
cell (the port of ``repro.launch.sweep``): each cell's fake process group
and meta trace start clean, and the sweep resumes, skipping a cell whose
record exists. Single-pod cells first, then the 2x16x16 ones; cheap cells
first within each.

  PYTHONPATH=src python -m repro_torch.launch.sweep [--jobs N] [--out DIR]
  PYTHONPATH=src python -m repro_torch.launch.sweep --table [--out DIR]

Records go to ``launch.dryrun.RESULTS`` (or ``--out``), the log to
``sweep_log.txt`` beside them. ``--table`` prints the traced records as a
markdown table (``table``) and traces nothing.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import pathlib
import subprocess
import sys
import time

from .dryrun import RESULTS

SRC = pathlib.Path(__file__).resolve().parents[2]


def cell_list():
    """[(multi_pod, arch, shape name)] of every supported cell."""
    from ..configs import SHAPES, get_config, shape_supported
    from ..configs.registry import ARCH_IDS
    out = []
    for multi in (False, True):
        for arch in ARCH_IDS:
            cfg = get_config(arch)
            for shape in SHAPES.values():
                ok, _ = shape_supported(cfg, shape)
                if ok:
                    cost = cfg.n_params() * (shape.seq_len ** 0.5)
                    out.append((multi, cost, arch, shape.name))
    out.sort(key=lambda t: (t[0], t[1]))
    return [(m, a, s) for (m, c, a, s) in out]


def _run(cell, out_dir: pathlib.Path, timeout: int):
    multi, arch, shape = cell
    tag = f"{arch}__{shape}__{'2x16x16' if multi else '16x16'}"
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--out", str(out_dir)]
    if multi:
        cmd.append("--multi-pod")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
    t0 = time.time()
    try:
        r = subprocess.run(cmd, env=env, timeout=timeout,
                           capture_output=True, text=True)
        tail = r.stdout[-2000:] + "\n" + r.stderr[-4000:]
        rc = r.returncode
    except subprocess.TimeoutExpired:
        tail, rc = "", "timeout"
    ok = (out_dir / f"{tag}.json").exists()
    return tag, ok, rc, time.time() - t0, tail


def table(out_dir: pathlib.Path) -> str:
    """The traced records of ``out_dir`` as a markdown table, one row a
    cell and each number as ``16x16 / 2x16x16``: a rank's peak in GB
    (10^9 bytes), marked ``!`` where it passes the card's memory
    (``memory.hbm_bytes``), its counted TFLOP a step, and its collectives'
    GB a step by kind (result bytes on the rank)."""
    kinds = ("all-reduce", "all-gather", "reduce-scatter")
    recs: dict = {}
    for p in sorted(out_dir.glob("*.json")):
        r = json.loads(p.read_text())
        if r.get("step") == "traced":
            recs.setdefault((r["arch"], r["shape"]), {})[r["mesh"]] = r

    def peak(r):
        mem = r["memory"]
        over = "!" if mem["peak_bytes"] > mem["hbm_bytes"] else ""
        return f"{mem['peak_bytes'] / 1e9:.2f}{over}"

    cols = [("peak GB", peak),
            ("TFLOP", lambda r: f"{r['flops'] / 1e12:.1f}")]
    cols += [(f"{k} GB", lambda r, k=k:
              f"{r['collectives'][k]['bytes'] / 1e9:.2f}") for k in kinds]
    rows = ["| cell | " + " | ".join(c for c, _ in cols) + " |",
            "|" + " --- |" * (len(cols) + 1)]
    for (arch, shape), by_mesh in sorted(recs.items()):
        meshes = [by_mesh[m] for m in ("16x16", "2x16x16") if m in by_mesh]
        rows.append(f"| {arch} {shape} | " + " | ".join(
            " / ".join(fn(r) for r in meshes) for _, fn in cols) + " |")
    return "\n".join(rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--timeout", type=int, default=3600)
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once (one process each)")
    ap.add_argument("--out", default=None,
                    help=f"records' directory (default {RESULTS})")
    ap.add_argument("--table", action="store_true",
                    help="print the traced records as a table and stop")
    args = ap.parse_args(argv)
    out_dir = pathlib.Path(args.out or RESULTS)
    if args.table:
        print(table(out_dir))
        return 0
    out_dir.mkdir(parents=True, exist_ok=True)
    todo = [c for c in cell_list() if not (out_dir / (
        f"{c[1]}__{c[2]}__{'2x16x16' if c[0] else '16x16'}.json")).exists()]
    failed = 0
    t_all = time.time()
    with (out_dir / "sweep_log.txt").open("a") as log, \
            concurrent.futures.ThreadPoolExecutor(args.jobs) as pool:
        for tag, ok, rc, dt, tail in pool.map(
                lambda c: _run(c, out_dir, args.timeout), todo):
            line = f"{tag}: {'OK' if ok else f'FAIL rc={rc}'} in {dt:.1f}s"
            print(f"[sweep] {line}", flush=True)
            log.write(line + "\n")
            if not ok:
                failed += 1
                log.write(tail + "\n")
            log.flush()
        log.write(f"sweep: {len(todo)} cells, {failed} failed, "
                  f"{time.time() - t_all:.1f}s\n")
    print(f"[sweep] done: {len(todo)} cells, {failed} failed, "
          f"{time.time() - t_all:.1f}s")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())

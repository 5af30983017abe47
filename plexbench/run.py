"""Run one cell of the benchmark once and print its result line.

    python3 plexbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout: the system under test is the checkout's
own ``src/repro_torch``, and its kernels build under the checkout's
``build/``. The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``; ``checks`` last, each number compared beside its limit, as on
the last lines of standard error). Without the cell's CUDA devices, without
the checkout's ``repro_torch``, or with JAX or the JAX package loaded once
the window has closed, it prints no result and exits non-zero.
"""
import time

T_PROC0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "plexbench"


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    # every build and kernel cache at a fixed place inside the checkout
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
    # the checkout's package and the benchmark's, never this folder's
    # modules by their bare names
    here = pathlib.Path(__file__).resolve().parent
    sys.path[:] = [str(ROOT / "src"), str(ROOT)] + [
        p for p in sys.path if pathlib.Path(p or ".").resolve() != here]
    try:
        import repro_torch
    except ImportError as e:
        print(f"plexbench: the system under test is missing: {e!r}",
              file=sys.stderr)
        return 2
    src = (ROOT / "src").resolve()
    if src not in pathlib.Path(repro_torch.__file__).resolve().parents:
        print(f"plexbench: repro_torch was loaded from "
              f"{repro_torch.__file__}, not from {src}", file=sys.stderr)
        return 2
    import json
    from plexbench import harness
    try:
        result = harness.run_cell(ROOT, args.workload, args.seed,
                                  args.seconds, bool(args.trace),
                                  t_proc0=T_PROC0)
    except harness.NoDevice as e:
        print(f"plexbench: {e}", file=sys.stderr)
        return 2
    found = harness.forbidden_modules()
    if found:
        print(f"plexbench: loaded in the measured process: "
              f"{', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} {c['rule']} {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

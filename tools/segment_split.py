#!/usr/bin/env python3
"""Where K2's and K3's time goes, on one CUDA card.

    python3 tools/segment_split.py [--seed 0] [--queries 1048576]

Builds ``tools/segment_split.cu`` (parts of
``src/repro_torch/kernels/csrc/segment_lookup.cu`` alone, and candidate
designs left out of it) with ``nvcc`` and times, with CUDA events
(``chip_smoke.device_ms``), each variant on 2^20 queries (90% present) over
each SOSD dataset's tuned index of 2^24 keys and over ``amzn`` with its
layer forced to radix and to CHT. Variants, timed in turns (forward, then
backward):

* ``stream``: read each query's key, write 4 bytes (12 B a query);
* ``layer``: the radix-table pair or the CHT descent alone;
* the layer plus the spline search in each form (``count``, ``bisect``,
  ``adaptive``), writing the predecessor; and candidates left out of the
  kernel: a bisect down to one 8-key segment counted with 16-byte loads;
  the fixed-trip bisect with two queries a thread interleaved; 8 lanes a
  query cutting the window 9 ways a step;
* CHT only, where level 0 fits in 48 KB: the descent with level 0 staged
  in shared memory;
* the whole kernel (``csrc/segment_lookup.cu``) in each form, and in the
  adaptive form without cache hints; the kernel fused with K4 in each form
  (and, with a one-level summary, in the adaptive form without the K2/K3
  part's cache hints), and the pair it replaces (K2/K3, then K4);
* ``torch.take`` of one spline key at each answer segment (one scattered
  8-byte read a query).

Every variant's predecessors agree, every form's window bases and fused
indices equal their plain versions, and the ranks equal
``np.searchsorted``. ``split`` is also run by ``chip_smoke.py``'s index
phase. Prints one JSON line per index and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
VARIANTS = {0: "stream", 1: "layer", 2: "layer_count", 3: "layer_bisect",
            4: "layer_adaptive", 5: "layer_segment", 6: "layer_bisect_x2",
            7: "layer_warp8", 8: "whole_adaptive_no_hints",
            9: "layer_level0_smem", 10: "fused_adaptive_no_hints"}
PREDECESSOR = (2, 3, 4, 5, 6, 7)      # variants that write the predecessor


def build() -> ctypes.CDLL:
    from repro_torch.kernels import _build
    out = _build.build_root() / "segment_split"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libsegment_split.so"
    done = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                           "-I", str(_build.CSRC), "-o", str(lib),
                           str(ROOT / "tools" / "segment_split.cu")],
                          capture_output=True, text=True)
    (out / "libsegment_split.log").write_text(done.stdout + done.stderr)
    if done.returncode:
        raise RuntimeError("nvcc failed for segment_split.cu: "
                           + (done.stdout + done.stderr)[-4000:])
    dll = ctypes.CDLL(str(lib))
    dll.segment_split.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_void_p]
    dll.segment_split.restype = ctypes.c_int
    dll.segment_split_params_size.restype = ctypes.c_int
    return dll


def warp8_steps(width: int) -> int:
    """Steps of the 9-way cut until every window holds at most 8 points."""
    steps = 0
    while width > 8:
        cuts = [(j * width) // 9 for j in range(10)]
        width = max(b - a for a, b in zip(cuts, cuts[1:]))
        steps += 1
    return steps


def geometry(pp) -> dict:
    """What sets the kernel's work on ``pp``: spline points, the widest
    window, the CHT's levels and the spline planes' bytes."""
    from repro_torch.kernels import segment_lookup as SEG
    s = pp.static
    return dict(layer=pp.kind, n_spline=pp.sk.numel(),
                search_width=SEG.search_width(pp),
                levels=s.get("levels"), radix_bits=s["r"],
                spline_bytes=pp.sk.numel() * 12,
                layer_bytes=next(iter(pp.layer_arrays.values())).numel() * 4)


def split(lib, pp, qd, device) -> dict:
    """Each variant over the device queries ``qd`` on the planes ``pp``,
    checked, then timed in turns; returns the milliseconds by variant."""
    import torch
    from chip_smoke import check, chunked, device_ms
    from repro_torch.kernels import bounded_search as BS
    from repro_torch.kernels import segment_lookup as SEG
    if lib.segment_split_params_size() != ctypes.sizeof(SEG._SegParams):
        raise RuntimeError("SegParams of segment_split.cu does not match")
    s = pp.static
    cht = pp.kind == "cht"
    width, trips = (SEG.cht_geometry(s["delta"]) if cht
                    else SEG.radix_geometry(s["max_win"]))
    out = torch.empty(qd.numel(), dtype=torch.int32, device=device)
    p = SEG._SegParams(
        q=qd.data_ptr(), sk=pp.sk.data_ptr(), spos=pp.spos.data_ptr(),
        out=out.data_ptr(), n_q=qd.numel(), n_spline=pp.sk.numel(),
        eps_eff=pp.eps_eff, base_max=pp.n_data - pp.window,
        search_width=width, r=s["r"])
    if cht:
        p.cells = pp.layer_arrays["cells"].data_ptr()
        p.levels, p.delta = s["levels"], s["delta"]
    else:
        p.table = pp.layer_arrays["table"].data_ptr()
        p.min_key, p.shift, p.p_max = (s["min_key"], s["shift"],
                                       (1 << s["r"]) - 1)
    stream = torch.cuda.current_stream(device).cuda_stream

    def run(v: int):
        def call():
            p.search_trips = warp8_steps(width) if v == 7 else trips
            err = lib.segment_split(ctypes.addressof(p), int(cht), v, stream)
            if err:
                raise RuntimeError(f"{VARIANTS[v]}: CUDA error {err}")
        return call

    sm = pp.summary
    p.dk, p.s1, p.s2 = (pp.dk.data_ptr(), sm.l1.data_ptr(),
                        sm.l2.data_ptr())
    p.n_row, p.n1, p.window = sm.row, sm.n1, pp.window
    variants = [v for v in VARIANTS
                if (v != 9 or (cht and (4 << s["r"]) <= 48 * 1024))
                and (v != 10 or sm.levels == 1)]
    ns = pp.sk.numel()
    seg = layer = None
    for v in variants:
        run(v)()
        torch.cuda.synchronize(device)
        got = out.clone()
        if v == 1:
            layer = got
        elif v == 9:
            check(torch.equal(got, layer), "layer_level0_smem differs from "
                  "the layer alone")
        elif v in PREDECESSOR:
            got = got.clamp(0, ns - 2)
            if seg is None:
                seg = got
            check(torch.equal(got, seg), f"{VARIANTS[v]}: predecessors "
                  f"differ from {VARIANTS[PREDECESSOR[0]]}'s")
        elif v == 8:
            check(torch.equal(got, SEG.window_base(pp, qd, "adaptive")),
                  "whole_adaptive_no_hints differs from the kernel")
        elif v == 10:
            check(torch.equal(got, SEG.window_probe(pp, qd, "adaptive")),
                  "fused_adaptive_no_hints differs from the fused kernel")
    base_plain = chunked(lambda c: SEG.window_base_plain(pp, c), qd)
    probe_plain = chunked(lambda c: SEG.window_probe_plain(pp, c), qd)
    calls = {VARIANTS[v]: run(v) for v in variants}
    for m in SEG.SEARCH_FORMS:
        check(torch.equal(SEG.window_base(pp, qd, m), base_plain),
              f"{pp.kind} kernel, {m} form, differs from its plain version")
        check(torch.equal(SEG.window_probe(pp, qd, m), probe_plain),
              f"fused {pp.kind} kernel, {m} form, differs from its plain "
              f"version")
        calls[f"kernel_{m}"] = (lambda m=m: SEG.window_base(pp, qd, m))
        calls[f"fused_{m}"] = (lambda m=m: SEG.window_probe(pp, qd, m))
    seg = seg.long()
    calls["pair"] = lambda: BS.bounded_search(
        pp.dk, qd, SEG.window_base(pp, qd), window=pp.window,
        summary=pp.summary)
    calls["torch_take"] = lambda: torch.take(pp.sk, seg)
    check(torch.equal(calls["pair"](), probe_plain),
          "K2/K3 then K4 differs from the fused plain version")
    times: dict = {name: [] for name in calls}
    order = list(calls)
    for name in order + order[::-1]:
        times[name].append(device_ms(calls[name], device, reps=10))
    return dict(geometry(pp), card_form=SEG.CARD_FORM,
                ms={k: float(sum(v) / len(v)) for k, v in times.items()},
                ms_runs=times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--queries", type=int, default=1 << 20)
    ap.add_argument("--keys", type=int, default=1 << 24)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("segment_split: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from chip_smoke import INDEX_DATASETS, _forced, check, make_queries
    from repro_torch.core import LearnedIndex
    from repro_torch.data import generate
    from repro_torch.kernels.keys import to_biased
    from repro_torch.kernels.ops import DevicePlex
    device = torch.device("cuda", 0)
    lib = build()
    rng = np.random.default_rng(args.seed + 3)
    for ds in INDEX_DATASETS:
        keys = generate(ds, args.keys, args.seed)
        idx = LearnedIndex.build(keys, 64, device=device)
        q = make_queries(keys, args.queries, rng)
        check(np.array_equal(idx.lookup(q), np.searchsorted(keys, q, "left")),
              f"{ds}: ranks differ from searchsorted")
        qd = torch.from_numpy(to_biased(q)).to(device)
        layers = [("tuned", idx.backend_impl().planes)]
        if ds == "amzn":
            layers += [(f"forced_{k}", DevicePlex.from_plex(
                _forced([idx.plex], k)[0], device=device).planes)
                for k in ("radix", "cht")]
        for name, pp in layers:
            print(json.dumps(dict(dataset=ds, index=name, keys=args.keys,
                                  queries=int(q.size),
                                  **split(lib, pp, qd, device))), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

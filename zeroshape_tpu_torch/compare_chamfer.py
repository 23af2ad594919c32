"""Hold builds of the Chamfer kernels (K2, K3) to their plain versions and
time them against each other on one GPU, in turns.

    python -m zeroshape_tpu_torch.compare_chamfer [SOURCE.cu ...] [--rounds 2] [--sass-dir DIR]

Every source exports ``zs_nn_one_way`` and ``zs_nn_min_fast`` with the C
signatures of ``csrc/chamfer.cu`` (the default, alone): another design of the
same kernels, or an earlier version of that file. All are built at once, one
``nvcc`` each. Then, for each build:

1. the checks against ``ops/chamfer.py``'s plain versions, at the shapes a
   tile-based design gets wrong: ragged N and M (1, 7, 17, 777, 1,000), a
   cloud shared by the batch (stride 0) on either side, duplicate points in B
   (the lower index must win). K2: refined distances within 1e-5, argmins
   equal on >= 99.9% of points and equally near within 1e-5 where not. K3:
   within 1e-5;
2. the SASS of each kernel (``cuobjdump``): the opcodes of its densest loop
   (the most min instructions for its length) and the instructions a pair
   there, the loop's length over its FMNMX count (FSETP for a kernel that
   has no FMNMX).

Then the times: K2 at the exact brute-force stage's shape (B=48, N=M=10,000)
and K3 at the coarse stage's (B=192, N=M=1,024), each the mean over a CUDA
graph of 20 launches timed with CUDA events (the host's launch cost stays
out), build after build, forward then backward, ``--rounds`` times. The
last line is a JSON summary; the exit code is 1 if a build failed a check.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from zeroshape_tpu_torch.ops import _build
from zeroshape_tpu_torch.ops import chamfer as ch

CASES = [(2, 64, 64), (3, 1000, 777), (2, 17, 1), (2, 7, 17), (1, 777, 1000), (2, 1, 7)]


def clouds(B, N, M, seed):
    """Unit-scale clouds on the card: x1 uniform in [-1, 1]^3, x2 normal with sigma 0.5."""
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(B, N, 3, generator=g) * 2 - 1).cuda(), (torch.randn(B, M, 3, generator=g) * 0.5).cuda()


def graph_ms(fn, iters=20):
    """Mean milliseconds per call of ``fn``: a CUDA graph of ``iters`` calls,
    replayed once to warm up and once under CUDA events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@contextlib.contextmanager
def using(lib):
    """Route ``ops/chamfer.py``'s wrappers to the loaded library ``lib``."""
    saved = ch._library
    ch._library = lambda: lib
    try:
        yield
    finally:
        ch._library = saved


def k2_agreement(x1, x2):
    """K2 against its plain version: (max |d| of the refined distances,
    share of equal argmins, max |d| between the two candidates where they
    differ, the kernel's indices)."""
    dist, idx = ch.nn_one_way(x1, x2)
    _, ref_idx = ch._nn_one_way_plain(x1, x2)
    ref = ch._refine(x1, x2, ref_idx)
    same = idx == ref_idx
    gap = float((ch._refine(x1, x2, idx) - ref)[~same].abs().max()) if not bool(same.all()) else 0.0
    return float((dist - ref).abs().max()), float(same.float().mean()), gap, idx


def check(name):
    """The checks of step 1 on the routed build; returns the failures."""
    bad = []
    for k, (B, N, M) in enumerate(CASES):
        x1, x2 = clouds(B, N, M, seed=20 + k)
        for what, a, b in (("", x1, x2), (" A shared", x1[:1].expand(B, -1, -1), x2),
                           (" B shared", x1, x2[:1].expand(B, -1, -1))):
            err, share, gap, _ = k2_agreement(a, b)
            err3 = float((ch.nn_min_squared_fast(a, b) - ch._nn_min_plain(a, b)).abs().max())
            line = f"[{B},{N},{M}]{what}: K2 max|d| {err:.2e} argmins {share:.4f} gap {gap:.2e}; K3 max|d| {err3:.2e}"
            if err > 1e-5 or share < 0.999 or gap >= 1e-5 or err3 > 1e-5:
                bad.append(line)
    x1, x2 = clouds(2, 1000, 500, seed=30)
    dup = torch.cat([x2, x2], dim=1)  # point j and j + 500 coincide: j must win
    err, share, gap, idx = k2_agreement(x1, dup)
    if int(idx.max()) >= 500 or err > 1e-5 or share < 0.999:
        bad.append(f"duplicates: max index {int(idx.max())} (want < 500), max|d| {err:.2e}, argmins {share:.4f}")
    torch.cuda.synchronize()
    print(f"{name}: checks {'passed' if not bad else 'FAILED'} ({len(CASES) * 3 + 1} cases)")
    for line in bad:
        print(f"  {line}")
    return bad


def cuobjdump():
    from torch.utils.cpp_extension import CUDA_HOME

    tool = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump")
    return tool if os.path.exists(tool) else None


_INS = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")


def densest_loops(sass):
    """For each kernel of a SASS listing: (name, loop length, min count,
    opcode counts) of the loop with the most FMNMX (else FSETP) a line."""
    out = []
    for name, body in re.findall(r"Function : (\S+)\n(.*?)(?=Function : |\Z)", sass, re.S):
        ins = [(int(a, 16), op, rest) for a, op, rest in _INS.findall(body)]
        key = "FMNMX" if any(op.startswith("FMNMX") for _, op, _ in ins) else "FSETP"
        best = None
        for addr, op, rest in ins:
            m = re.match(r"\s*0x([0-9a-f]+)", rest)
            if op != "BRA" or not m or int(m.group(1), 16) >= addr:
                continue
            loop = [o for a, o, _ in ins if int(m.group(1), 16) <= a <= addr]
            n = sum(o.startswith(key) for o in loop)
            if n and (best is None or n / len(loop) > best[1] / len(best[0])):
                best = (loop, n)
        if best is not None:
            hist = {}
            for o in best[0]:
                hist[o.split(".")[0]] = hist.get(o.split(".")[0], 0) + 1
            out.append((name, len(best[0]), best[1], key, dict(sorted(hist.items(), key=lambda kv: -kv[1]))))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="*", default=[os.path.join(_build.CSRC, "chamfer.cu")])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--sass-dir", default=None, help="write each build's full SASS listing here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("compare_chamfer: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")

    sources = [os.path.abspath(s) for s in args.sources]
    names = [f"zs_chamfer_cmp{k}" for k in range(len(sources))]
    with ThreadPoolExecutor(len(sources)) as pool:
        builds = list(pool.map(lambda sn: _build.build(*sn), zip(sources, names)))
    libs = []
    for src, name, (seconds, log) in zip(sources, names, builds):
        print(f"build: {src} in {seconds:.1f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Performance" in line:
                print(f"  ptxas: {line.strip()}")
        libs.append(_build.library(src, name, ch.SIGNATURES))

    failed, sass = {}, {}
    tool = cuobjdump()
    for src, name, lib in zip(sources, names, libs):
        with using(lib), torch.inference_mode():
            failed[src] = check(os.path.basename(src))
        if tool is None:
            continue
        listing = subprocess.run([tool, "-sass", _build.library_path(name)], capture_output=True, text=True).stdout
        if args.sass_dir:
            os.makedirs(args.sass_dir, exist_ok=True)
            with open(os.path.join(args.sass_dir, os.path.basename(src) + ".sass"), "w") as f:
                f.write(listing)
        sass[src] = []
        for fn, length, n, key, hist in densest_loops(listing):
            print(f"SASS {os.path.basename(src)} {fn[:60]}: densest loop {length} instructions, {n} {key}: "
                  f"{length / n:.2f} a pair; {hist}")
            sass[src].append({"kernel": fn, "loop": length, key: n, "per_pair": length / n})

    k2_in, k3_in = clouds(48, 10000, 10000, seed=5), clouds(192, 1024, 1024, seed=7)
    times = {src: {"K2": [], "K3": []} for src in sources}
    order = list(range(len(sources)))
    with torch.inference_mode():
        for r in range(args.rounds):
            for k in order + order[::-1]:
                with using(libs[k]):
                    k2 = graph_ms(lambda: ch.nn_one_way(*k2_in))
                    k3 = graph_ms(lambda: ch.nn_min_squared_fast(*k3_in))
                times[sources[k]]["K2"].append(k2)
                times[sources[k]]["K3"].append(k3)
                print(f"round {r}: {os.path.basename(sources[k])}: K2 {k2:.4f} ms at [48,10k,10k], "
                      f"K3 {k3:.4f} ms at [192,1024,1024]")
    for src in sources:
        t = times[src]
        print(f"{src}: K2 mean {sum(t['K2']) / len(t['K2']):.4f} ms (min {min(t['K2']):.4f}), "
              f"K3 mean {sum(t['K3']) / len(t['K3']):.4f} ms (min {min(t['K3']):.4f})")
    print(json.dumps({"card": smi, "builds": [{"source": s, "checks_failed": failed[s], "sass": sass.get(s),
                                               **times[s]} for s in sources]}))
    sys.exit(1 if any(failed.values()) else 0)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Where the block form of K1's solve (``k1_solve_block``,
``csrc/solve_kernel.cu``) spends a block's time, stage by stage, on the card.

    python3 chip_solve_phases.py

Builds a copy of the package's ``csrc/solve_kernel.cu`` into ``build/probe/``
in which the first thread of each block of ``k1_solve_block`` reads
``clock64()`` at the head of each of its stages (the source's ``// ---- N.``
comments) and at its end, and runs it in the plan's layout
(``ops/solve_kernel.py::solve_layout``) on phase 21's inputs of
``chip_smoke.py``: path A's at (K, H) = (17, 65), (20, 80), (32, 128),
(40, 256), S = 4096, phi_k given; 512 distinct maps with 100 drawn history
positions at (17, 65) and (40, 256). Each run's outputs must equal the
package's own build's bit for bit. It prints, beside the card's name and
power limit, the ms a call (CUDA events) and the mean cycles a block spends
in each stage: the rollout; the history sums, c_k and the metric; the
gradient; the walls and the obstacle; the co-state and u; the safety stage.
A block's cycles include the time its SM gives the other blocks it holds.
Needs a CUDA device; exits 2 without one.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
STAGES = ("rollout", "history + c_k + metric", "gradient", "walls + obstacle",
          "co-state + u", "safety")
MARKS = ("// ---- 1. RK4", "// ---- 2-3.", "// ---- 4. the ergodic", "// ---- 5. walls",
         "// ---- 6. backward", "// ---- 7. safety")
MAX_BLOCKS = 4096


def stamped_source(src: str) -> str:
    """``src`` with the stamps in ``k1_solve_block`` and an entry point
    ``k1_phase_stamps(out, n)`` that copies the first n of them out."""
    head = "template <int NT>\n__global__ void __launch_bounds__(NT, 512 / NT) k1_solve_block"
    i0 = src.index(head)
    i1 = src.index("// safety alone, on a crop given as data")
    body = src[i0:i1]
    for n, mark in enumerate(MARKS):
        if mark not in body:
            raise RuntimeError(f"k1_solve_block has no stage comment {mark!r}")
        body = body.replace(mark, f"if (threadIdx.x == 0) k1_stamps[blockIdx.x * 8 + {n}] = "
                                  f"clock64();\n    {mark}", 1)
    end = body.rindex("\n}\n")
    body = (body[:end] + f"\n    if (threadIdx.x == 0) k1_stamps[blockIdx.x * 8 + {len(MARKS)}] "
            f"= clock64();" + body[end:])
    stamps = (f"__device__ long long k1_stamps[{MAX_BLOCKS} * 8];\n"
              "extern \"C\" int k1_phase_stamps(long long* out, int n) {\n"
              "    return (int)cudaMemcpyFromSymbol(out, k1_stamps, n * sizeof(long long));\n"
              "}\n")
    return src[:i0] + stamps + body + src[i1:]


def build(sk, cb):
    """The stamped library, behind a fresh K1 wrapper."""
    out = HERE / "build" / "probe"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / "solve_phases.cu"
    cu.write_text(stamped_source((cb.CSRC / "solve_kernel.cu").read_text()))
    so = out / "solve_phases.so"
    proc = subprocess.run([cb._nvcc(), *cb.NVCC_FLAGS, f"-I{cb.CSRC}", "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr[-3000:]}")
    lib = ctypes.CDLL(str(so))
    for fn in (lib.k1_fused_solve_safety, lib.k1_refresh_phik):
        fn.argtypes = [ctypes.POINTER(sk._Params), ctypes.POINTER(sk._Buffers), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.k1_smem_optin.restype = ctypes.c_int
    lib.k1_phase_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.k1_phase_stamps.restype = ctypes.c_int
    wrapper = sk.FusedSolveSafety()
    wrapper.built = SimpleNamespace(lib=lib)
    return wrapper, lib


def measure(tag, cfg, inp, wrapper, lib, sk, smoke, card) -> None:
    import torch

    S = inp.x.shape[0]
    ref = sk.K1(cfg, inp)
    got = wrapper(cfg, inp)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, ref) if a is not None):
        raise RuntimeError(f"{tag}: the stamped build differs from the package's")
    ms = smoke.events_ms(lambda: wrapper(cfg, inp), 10)
    wrapper(cfg, inp)
    torch.cuda.synchronize()
    n = min(S, MAX_BLOCKS)
    st = torch.zeros(n * 8, dtype=torch.int64)
    if lib.k1_phase_stamps(st.data_ptr(), n * 8):
        raise RuntimeError("reading the stamps failed")
    st = st.view(n, 8)[:, :len(MARKS) + 1].double()
    each = (st[:, 1:] - st[:, :-1]).mean(0).tolist()
    nb = inp.hist.shape[1] if inp.hist.dim() == 3 else 0
    layout = sk.solve_layout(cfg.num_basis, cfg.horizon, nb, sk.MAX_SMEM, S,
                             torch.cuda.get_device_properties(0).multi_processor_count)
    print(f"{tag}, S={S}, {layout}: {ms:.4f} ms a call; cycles a block "
          f"{(st[:, -1] - st[:, 0]).mean().item():.0f}: "
          + ", ".join(f"{name} {c:.0f}" for name, c in zip(STAGES, each)) + f" {card}",
          flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_solve_phases.py needs a CUDA device; none is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import chip_smoke as smoke
    from ergodic_exploration_tpu_torch.engine import Engine
    from ergodic_exploration_tpu_torch.ops import solve_kernel as sk
    from ergodic_exploration_tpu_torch.utils import cuda_build as cb

    dev = torch.device("cuda", 0)
    card = "[" + subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                 "--format=csv,noheader"], capture_output=True, text=True,
                                check=True).stdout.strip().splitlines()[0] + "]"
    wrapper, lib = build(sk, cb)
    for K, H in smoke.WIDE_SHAPES:
        engine, sc, world, gmm, domain = smoke.wide_case(smoke.S_MAIN, dev, K, H)
        cfg = engine.config
        sc, u, _ = engine.replan_refresh(sc, gmm, domain, world)
        sc = smoke.advance(engine, sc, u)
        inp, _ = sk.fused_tick_inputs(cfg, sc.state, sc.x, sc.vb, None, world, gmm, domain)
        inp = inp._replace(refresh=None, phik=sk.K1.refresh(inp.refresh, inp.dlen))
        measure(f"path A K{K}_H{H}", cfg, inp, wrapper, lib, sk, smoke, card)
        del engine, sc, world, inp
        torch.cuda.empty_cache()
    for K, H in (smoke.WIDE_SHAPES[0], smoke.WIDE_SHAPES[-1]):
        cfg, x0, grids, gmm, dom = smoke.distinct_case(smoke.WIDE_S, dev, num_basis=K,
                                                       horizon=H)
        eng = Engine(cfg)
        world = eng.prepare_world(grids)
        phik = eng.phik_from_gmm(gmm, dom, world)
        sc = eng.explore(eng.init_scenarios(x0), phik, world, smoke.WIDE_TICKS).scenarios
        inp, _ = sk.fused_tick_inputs(cfg, sc.state, sc.x, sc.vb, phik, world)
        measure(f"{smoke.WIDE_S} distinct maps K{K}_H{H}", cfg, inp, wrapper, lib, sk, smoke,
                card)
        del eng, world, phik, sc, inp
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""conv3x3's f32 (3xTF32) kernel at C <= 64: what holds it back, and a checkout against this one.

    python scripts/torch_conv_f32_probe.py split [--root DIR]   # timing-only variants of a kernel
    python scripts/torch_conv_f32_probe.py root --root DIR      # DIR's kernel against this one's

``split``: the f32 conv of ``csrc/conv3x3_same.cu`` at ``--root`` (default:
this checkout) at 64@512, batch 8, in both of its modes (MODE_BIAS_RELU,
the fused forward; MODE_CONV on the dgrad planes, the f32 dgrad), as built
and with one cause of lost time taken away at a time. The variants exist for
timing only; most compute wrong values:

- ``no_store``: the epilogue's TMA store skipped (staging and barriers kept);
- ``no_epilogue``: the whole f32 epilogue skipped;
- ``resident_w``: each weight ring filled once, then every stage re-read as
  it stands (no L2 weight reloads);
- ``one_cvt``: the A split's small part not rounded (one rounding, not two);
- ``no_split``: no A split at all (both parts the raw f32 bits);
- ``bit_split`` (a kernel that splits with ``cvt.rna``): the split on the
  bits (+0x1000, clear the low 13), which gives ``cvt.rna``'s values;
- ``cvt_split`` (the ``tf32x3_c64`` kernel, which splits on the bits): its
  split with ``cvt.rna``;
- ``no_stagger`` (``tf32x3_c64``): its second pipeline starts with the first.

The last three change no value and are held bit for bit. A variant whose
kernel text is not in the source is skipped (``skipped``). Each is built
into ``build/conv_f32_probe/`` with ``nvcc -Xptxas -v`` and timed by graph
replay (``utils/timing.graph_ms``) in turns: as built, every variant, every
variant again in reverse, as built. Also printed: ptxas's registers and
spills for the f32 C <= 64 instances, the most frequent SASS opcodes of the
fused one (``cuobjdump``), and, where ``ncu`` is on the machine, its L2 and
tensor-pipe throughput for the as-built kernel (or the error it gives: in a
sandbox ``ncu`` may be installed yet unable to load its counters).

``root``: ``--root``'s ``conv3x3_same.cu`` (an older checkout, unpacked with
``git archive``) against this checkout's, both through this checkout's
wrappers (the C interface and the weight packing are the same), at the f32
C <= 64 sites: 64@512 and 64@256 (fused forward, bias-free forward and
dgrad), one rank's band of each on a 1x2 mesh (pads (1, 0) and (0, 1),
dgrad (1, 2) and (2, 1)), and 16, 32 and 48 channels; the two outputs are
compared bit for bit on the same seeded inputs, and the 64@512 and 64@256
calls are timed in turns (root, this, this, root). ``same_code`` lists the
kernels the two sources compile to the same SASS (``cuobjdump``) and those
that differ or exist in one only.

Prints one JSON line per result. Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "build" / "conv_f32_probe"
SHAPE = (8, 64, 512, 512)

# The A split: the streamed kernel's (cvt.rna, before this variant existed)
# and the PIPES kernel's (on the bits).
SPLIT_CVT = """                  const uint32_t big = tf32_rna(__uint_as_float(raw[i]));
                  a[tap & 1][s][ks][i] = big;
                  a_small[tap & 1][s][ks][i] =
                      tf32_rna(__uint_as_float(raw[i]) - __uint_as_float(big));"""
SPLIT_BITS = """                      const uint32_t big = tf32_rna_bits(raw[i]);
                      a[buf][s][kk][i] = big;
                      a_small[buf][s][kk][i] = tf32_rna_bits(
                          __float_as_uint(__uint_as_float(raw[i]) - __uint_as_float(big)));"""
STORE = "if (cb < p.c) tma_store_4d("
EPILOGUE = "      const uint32_t stage = RESIDENT ? halo_g + last_hs * C::HALO_BYTES : out0;"
EPILOGUE_HALO = ("      const uint32_t stage = C::STAGE_IN_HALO ? halo_g + last_hs * C::HALO_BYTES : "
                 "out0;")
W_LOAD = "              mbar_expect_tx(wfull + 8 * ws, C::W_TILE);"
STAGGER = "    if (LAYOUT == PIPES && g == 1) mbar_wait(go, 0);"


def _skip_epilogue(anchor: str, release: str = "") -> str:
    # The accumulators stay live (ptxas drops a wgmma whose result is unused).
    return ("      if constexpr (C::F32) {\n"
            "        float sum = 0.0f;\n"
            "        for (int s = 0; s < SLABS; ++s)\n"
            "          for (int i = 0; i < BN / 2; ++i) sum += acc[s][i];\n"
            "        if (sum == 1234.5f) __trap();\n" + release +
            "        continue;\n"
            "      }\n" + anchor)


# name -> alternatives, each a list of (text, replacement); the first
# alternative whose texts all occur once in the kernel is taken, and a variant
# with none is skipped. Older kernel first, then the PIPES one.
VARIANTS = {
    "no_store": [[(STORE, "if (cb < 0) tma_store_4d(")]],
    "no_epilogue": [[(EPILOGUE, _skip_epilogue(EPILOGUE))],
                    [(EPILOGUE_HALO, _skip_epilogue(
                        EPILOGUE_HALO, "        if (C::STAGE_IN_HALO) mbar_arrive(hempty + 8 * last_hs);\n"))]],
    "resident_w": [[(W_LOAD, "              if (wi >= C::W_STAGES) { mbar_arrive(wfull + 8 * ws); "
                             "continue; }\n" + W_LOAD)]],
    "one_cvt": [[(SPLIT_CVT, SPLIT_CVT.replace(
        "tf32_rna(__uint_as_float(raw[i]) - __uint_as_float(big))",
        "__float_as_uint(__uint_as_float(raw[i]) - __uint_as_float(big))"))],
                [(SPLIT_BITS, SPLIT_BITS.replace(
                    "tf32_rna_bits(\n                          __float_as_uint(", "(\n"
                    "                          __float_as_uint("))]],
    "no_split": [[(SPLIT_CVT, "                  a[tap & 1][s][ks][i] = raw[i];\n"
                              "                  a_small[tap & 1][s][ks][i] = raw[i];")],
                 [(SPLIT_BITS, "                      a[buf][s][kk][i] = raw[i];\n"
                               "                      a_small[buf][s][kk][i] = raw[i];")]],
    "bit_split": [[(SPLIT_CVT, SPLIT_CVT.replace(
        "tf32_rna(__uint_as_float(raw[i]))", "((raw[i] + 0x1000u) & ~0x1FFFu)").replace(
        "tf32_rna(__uint_as_float(raw[i]) - __uint_as_float(big))",
        "((__float_as_uint(__uint_as_float(raw[i]) - __uint_as_float(big)) + 0x1000u) & ~0x1FFFu)"))]],
    "cvt_split": [[(SPLIT_BITS, """                      const uint32_t big = tf32_rna(__uint_as_float(raw[i]));
                      a[buf][s][kk][i] = big;
                      a_small[buf][s][kk][i] =
                          tf32_rna(__uint_as_float(raw[i]) - __uint_as_float(big));""")]],
    "no_stagger": [[(STAGGER, "")]],
}
# Variants that change no value: held bit for bit against the kernel as built.
EXACT = ("bit_split", "cvt_split", "no_stagger")
# The fused f32 instance at 64 output channels per tile (mangled): its
# layout flag (streamed, or PIPES), then BIAS_RELU = true, DGRAD = false.
FUSED_F32_64 = r"conv3x3_wgmma_kernelIfLi64E\w+?Lb1ELb0E"


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def _setup():
    sys.path.insert(0, str(ROOT))
    os.chdir(ROOT)
    from unet_embroidery_seg_torch.ops import _build

    _build.build(["conv3x3_same"])
    OUT.mkdir(parents=True, exist_ok=True)
    return _build


def _compile(_build, sources: dict[str, str], out: Path = OUT) -> tuple[dict[str, Path], dict[str, str]]:
    """nvcc -Xptxas -v of each source text into ``out``, all at once: (.so by name, ptxas log by name).

    A source whose text, library and log an earlier run left in ``out`` is not built again.
    """
    out.mkdir(parents=True, exist_ok=True)
    jobs, libs, logs = {}, {}, {}
    for name, text in sources.items():
        src = out / f"{name}.cu"
        lib = out / f"{name}.so"
        if lib.exists() and src.exists() and src.read_text() == text:  # built by an earlier run
            libs[name], logs[name] = lib, (out / f"{name}.log").read_text()
            continue
        src.write_text(text)
        lib.unlink(missing_ok=True)
        jobs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        logs[name] = log.decode(errors="replace")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{logs[name][-4000:]}")
        (out / f"{name}.log").write_text(logs[name])
        libs[name] = lib
    return libs, logs


def _ptxas_f32_64(log: str, kernel: str = "IfLi64") -> list[str]:
    """ptxas's lines for the instances ``conv3x3_wgmma_kernel<kernel>...`` (registers, spills).

    ``kernel`` is the start of the mangled template arguments: the f32
    instances at 64 output channels by default.
    """
    lines, out = log.splitlines(), []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and f"conv3x3_wgmma_kernel{kernel}" in line:
            name = re.search(rf"kernel{kernel}E\w*?E(?=E|v)", line)
            out.append(" | ".join([name.group(0) if name else line.strip()]
                                  + [x.strip() for x in lines[i + 2:i + 4]]))
    return out


def _sass_opcodes(lib: Path, top: int = 30, kernel: str = FUSED_F32_64) -> dict:
    """The most frequent SASS opcodes of one instance (``kernel``, a regex of its mangled name;
    by default the fused f32 C <= 64 one), from cuobjdump."""
    from torch.utils.cpp_extension import CUDA_HOME

    tool = os.path.join(CUDA_HOME or "", "bin", "cuobjdump")
    if not os.path.exists(tool):
        tool = shutil.which("cuobjdump")
    if tool is None:
        return {"error": "cuobjdump not found"}
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True).stdout
    counts, inside, total = Counter(), False, 0
    for line in text.splitlines():
        if "Function :" in line:
            inside = re.search(kernel, line) is not None
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if inside and m:
            counts[m.group(1)] += 1
            total += 1
    return {"instructions": total, "top": counts.most_common(top)}


def _sass_functions(lib: Path) -> dict[str, list[str]]:
    """Each kernel's SASS instructions (addresses and encodings dropped), by mangled name.

    The anonymous namespace's name (a hash of the source file's name) is
    dropped, and a name of an older checkout's tensor-core kernel, whose
    third template argument was ``bool RESIDENT``, is written as the ``int
    LAYOUT`` it became (false: STREAMED = 0, true: RESIDENT = 1), so the two
    compare.
    """
    from torch.utils.cpp_extension import CUDA_HOME

    tool = os.path.join(CUDA_HOME or "", "bin", "cuobjdump")
    text = subprocess.run([tool if os.path.exists(tool) else "cuobjdump", "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    funcs: dict[str, list[str]] = {}
    body = None
    for line in text.splitlines():
        if "Function :" in line:
            name = re.sub(r"\d*_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]+", "_GLOBAL__N_",
                          line.split("Function :", 1)[1].strip())
            name = re.sub(r"(conv3x3_wgmma_kernelI(?:13__nv_bfloat16|f)Li(?:64|128)E)Lb([01])E",
                          r"\1Li\2E", name)
            body = funcs.setdefault(name, [])
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?);", line)
        if body is not None and m:
            body.append(" ".join(m.group(1).split()))
    return funcs


def _same_code(root_lib: Path, this_lib: Path) -> dict:
    """Which kernels the two libraries compile to the same SASS, and which they do not share."""
    a, b = _sass_functions(root_lib), _sass_functions(this_lib)
    both = sorted(set(a) & set(b))
    return {"identical": [k for k in both if a[k] == b[k]],
            "differ": [k for k in both if a[k] != b[k]],
            "only_root": sorted(set(a) - set(b)), "only_this": sorted(set(b) - set(a))}


def _inputs(c: int, n: int, h: int, w: int, seed: int):
    gen = torch.Generator().manual_seed(seed)
    cl = torch.channels_last
    x = torch.relu(torch.randn(n, c, h, w, generator=gen)).cuda().contiguous(memory_format=cl)
    g = torch.randn(n, c, h, w, generator=gen).cuda().contiguous(memory_format=cl)
    wt = (torch.randn(c, c, 3, 3, generator=gen) / (3 * c ** 0.5)).cuda().contiguous(
        memory_format=cl)
    b = (0.1 * torch.randn(c, generator=gen)).cuda()
    return x, g, wt, b


def _calls(c: int, n: int, h: int, w: int, pad=(1, 1), seed: int = 0,
           dtype: torch.dtype = torch.float32) -> dict:
    """The fused forward, the bias-free forward and dgrad of one call in ``dtype``, as the model
    makes them (weights and bias f32, as the model holds them)."""
    from unet_embroidery_seg_torch.ops import conv3x3 as C

    x, g, wt, b = _inputs(c, n, h, w, seed)
    x, g = x.to(dtype), g.to(dtype)
    packed = C.pack_conv3x3_grad(wt, dtype)
    gd = g[:, :, :C.out_rows(h, pad)].contiguous(memory_format=torch.channels_last)
    dp = C.dgrad_pad(pad)
    return {"fused": lambda: C.conv3x3_bias_relu(x, wt, b, pad),
            "same": lambda: C.conv3x3_same(x, wt, pad),
            "dgrad": lambda: C.conv3x3_dgrad(gd, wt, dp, packed)}


def _use(_build, lib) -> None:
    _build._libs["conv3x3_same"] = lib
    _build._fns.clear()


def _time(_build, libs: dict, order: list[str], fn) -> dict[str, list[float]]:
    from unet_embroidery_seg_torch.utils.timing import event_ms, graph_ms

    ms: dict[str, list[float]] = {}
    for name in order:
        _use(_build, libs[name])
        ms.setdefault(name, []).append(graph_ms(fn, event_ms(fn)))
    return ms


def _flops(c: int, n: int, oh: int, w: int) -> float:
    return 2.0 * 9 * c * c * n * oh * w


def _bound_ms(c: int, n: int, oh: int, w: int) -> float:
    return _flops(c, n, oh, w) / (495e12 / 3) * 1e3  # 3xTF32 at the dense TF32 rate


def _ncu(root: Path) -> dict:
    tool = shutil.which("ncu")
    if tool is None:
        from torch.utils.cpp_extension import CUDA_HOME

        cand = os.path.join(CUDA_HOME or "", "bin", "ncu")
        tool = cand if os.path.exists(cand) else None
    if tool is None:
        return {"ncu": "not on this machine"}
    metrics = ("lts__t_bytes.sum.per_second,lts__t_sectors_srcunit_tex_op_read.sum.per_second,"
               "sm__pipe_tensor_op_gmma_cycles_active.avg.pct_of_peak_sustained_active,"
               "gpu__time_duration.sum")
    try:
        res = subprocess.run([tool, "--metrics", metrics, "--kernel-name", f"regex:{FUSED_F32_64}",
                              "-c", "1", sys.executable, __file__, "once", "--root", str(root)],
                             capture_output=True, text=True, timeout=240)
        return {"ncu": (res.stdout + res.stderr)[-3000:]}
    except (subprocess.TimeoutExpired, OSError) as e:
        return {"ncu": f"failed: {e}"}


def split(root: Path) -> dict:
    _build = _setup()
    text = (root / "unet_embroidery_seg_torch" / "csrc" / "conv3x3_same.cu").read_text()
    sources, skipped = {"as_built": text}, []
    for name, alternatives in VARIANTS.items():
        for edits in alternatives:
            if all(text.count(old) == 1 for old, _ in edits):
                src = text
                for old, new in edits:
                    src = src.replace(old, new)
                sources[name] = src
                break
        else:
            skipped.append(name)
    libs, logs = _compile(_build, sources)
    cdlls = {name: ctypes.CDLL(str(lib)) for name, lib in libs.items()}
    out = {"card": card(), "root": str(root), "shape": list(SHAPE), "skipped": skipped,
           "ptxas": _ptxas_f32_64(logs["as_built"]), "sass": _sass_opcodes(libs["as_built"])}
    n, c, h, w = SHAPE
    calls = _calls(c, n, h, w)
    names = [k for k in sources if k != "as_built"]
    order = ["as_built", *names, *reversed(names), "as_built"]
    bound = _bound_ms(c, n, h, w)
    for mode in ("fused", "dgrad"):
        _use(_build, cdlls["as_built"])
        want = calls[mode]()
        equal = {}
        for name in (k for k in EXACT if k in cdlls):
            _use(_build, cdlls[name])
            equal[name] = torch.equal(calls[mode](), want)
        del want
        ms = _time(_build, cdlls, order, calls[mode])
        base = sum(ms["as_built"]) / 2
        out[mode] = {"bound_ms": bound, "equal_to_as_built": equal, "ms": ms,
                     "share_of_bound": {k: bound / (sum(v) / len(v)) for k, v in ms.items()},
                     "saved_vs_as_built": {k: 1 - (sum(v) / len(v)) / base for k, v in ms.items()}}
    _use(_build, ctypes.CDLL(str(_build.library_path("conv3x3_same"))))
    out.update(_ncu(root))
    return out


ROOT_CASES = [  # (label, C, N, H, W, pad, timed)
    ("64@512", 64, 8, 512, 512, (1, 1), True), ("64@256", 64, 8, 256, 256, (1, 1), True),
    ("64@512.band0", 64, 8, 257, 512, (1, 0), False), ("64@512.band1", 64, 8, 257, 512, (0, 1), False),
    ("64@256.band0", 64, 8, 129, 256, (1, 0), False), ("64@256.band1", 64, 8, 129, 256, (0, 1), False),
    ("48@96x72", 48, 2, 96, 72, (1, 1), False), ("32@33x47", 32, 3, 33, 47, (1, 1), False),
    ("16@40x24.band0", 16, 2, 41, 24, (1, 0), False), ("64@33x47", 64, 2, 33, 47, (1, 1), False),
]


def compare_root(root: Path) -> dict:
    _build = _setup()
    csrc = "unet_embroidery_seg_torch/csrc/conv3x3_same.cu"
    libs, logs = _compile(_build, {"root": (root / csrc).read_text(),
                                   "this": (ROOT / csrc).read_text()})
    this = ctypes.CDLL(str(_build.library_path("conv3x3_same")))
    pair = {"root": ctypes.CDLL(str(libs["root"])), "this": this}
    from unet_embroidery_seg_torch.ops.conv3x3 import conv3x3_path

    out = {"card": card(), "root": str(root), "path": conv3x3_path(64, torch.float32),
           "ptxas": {k: _ptxas_f32_64(v) for k, v in logs.items()},
           "sass": {k: _sass_opcodes(v, top=12) for k, v in libs.items()},
           "same_code": _same_code(libs["root"], libs["this"]), "cases": []}
    print("root_build " + json.dumps(out), flush=True)
    for i, (label, c, n, h, w, pad, timed) in enumerate(ROOT_CASES):
        calls = _calls(c, n, h, w, pad, seed=i)
        for mode, fn in calls.items():
            _use(_build, pair["root"])
            a = fn()
            _use(_build, pair["this"])
            b = fn()
            row = {"case": label, "mode": mode, "shape": [n, c, h, w], "pad": list(pad),
                   "equal": torch.equal(a, b), "max_abs_diff": (a - b).abs().max().item()}
            del a, b
            if timed:
                ms = _time(_build, pair, ["root", "this", "this", "root"], fn)
                oh = h if mode != "dgrad" else h  # SAME pads: out rows = in rows
                bound = _bound_ms(c, n, oh, w)
                row.update({"ms": ms, "bound_ms": bound,
                            "share_of_bound": {k: bound / (sum(v) / 2) for k, v in ms.items()}})
            out["cases"].append(row)
            print("root_case " + json.dumps(row), flush=True)
        del calls
        torch.cuda.empty_cache()
    _use(_build, this)
    out["all_equal"] = all(r["equal"] for r in out["cases"])
    return out


def once(root: Path) -> dict:
    """One fused launch of ``--root``'s kernel at 64@512 (for a profiler wrapped around it)."""
    _build = _setup()
    libs, _ = _compile(_build, {"once": (root / "unet_embroidery_seg_torch" / "csrc" /
                                          "conv3x3_same.cu").read_text()})
    _use(_build, ctypes.CDLL(str(libs["once"])))
    n, c, h, w = SHAPE
    _calls(c, n, h, w)["fused"]()
    torch.cuda.synchronize()
    return {"once": True}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("what", choices=("split", "root", "once"))
    parser.add_argument("--root", type=Path, default=ROOT,
                        help="checkout whose kernel `split` varies or `root` compares")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_conv_f32_probe: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.no_grad():  # the wrappers' packed-weight cache: each timed call is the kernel's
        result = {"split": split, "root": compare_root, "once": once}[args.what](args.root.resolve())
    print(json.dumps({args.what: result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

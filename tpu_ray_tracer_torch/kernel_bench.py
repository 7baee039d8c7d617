"""Measure the port's kernels on the card: device time, the compiler's
register and spill report, the SASS cost of the math functions the bounds
weigh, and the kinds of SASS instructions each kernel is made of.

    python -m tpu_ray_tracer_torch.kernel_bench [--sass-costs] [--sass-mix]
                                                [--json PATH]

``--sass-costs`` counts the SASS instructions that nvcc emits for an f32
division, sqrtf, rsqrtf, powf and cosf on their fast path (the weights of
``render/bounds.py``). ``--sass-mix`` sorts each kernel's SASS instructions
into f32 arithmetic, compares and selects, integer and address arithmetic,
memory, control and other. It needs one CUDA device and nvcc (with
cuobjdump beside it); it prints one JSON object as its last line and writes
it to ``--json`` when given. ``timed_ms`` is the device timing that
``chip_smoke.py`` and ``kernel_ab.py`` use.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re
import shutil
import subprocess
import sys

import torch

from .render import _build

# SASS opcodes by kind (the opcode before the first "."); the rest is "other"
SASS_KINDS = {
    "f32": ("FFMA", "FADD", "FMUL", "FMNMX", "MUFU", "FCHK", "FRND"),
    "compare_select": ("FSETP", "ISETP", "FSEL", "SEL", "PLOP3", "FSET", "ISET", "P2R", "R2P",
                       "VOTE", "PRMT"),
    "integer": ("IMAD", "IADD3", "LOP3", "SHF", "LEA", "IABS", "IMNMX", "FLO", "POPC", "I2F",
                "F2I", "F2F", "I2FP", "F2IP", "IMUL", "MOV", "S2R", "S2UR", "CS2R", "UMOV",
                "UIADD3", "ULDC", "UIMAD", "ULOP3", "USHF", "ULEA", "UISETP", "USEL"),
    "memory": ("LDS", "STS", "LDG", "STG", "LDC", "LDL", "STL", "LD", "ST", "ATOMS", "ATOMG",
               "RED", "ATOM"),
    "shuffle": ("SHFL",),
    "control": ("BRA", "BSSY", "BSYNC", "EXIT", "CALL", "RET", "WARPSYNC", "BAR", "BREAK",
                "BPT", "JMP", "YIELD", "NANOSLEEP"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def timed_ms(fn, frames: int, device_only: bool = False) -> float:
    """Time per call of ``fn(k)`` for k in range(frames), by CUDA events
    around the whole run: with host gaps between calls included, or
    (``device_only``) with the calls queued behind a ~10 ms sleep kernel, so
    that the device runs their launches back to back."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if device_only:
        torch.cuda._sleep(20_000_000)
    start.record()
    for k in range(frames):
        fn(k)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / frames


def _short_name(mangled: str) -> str:
    """``render_fwd_kernel<...>`` from a mangled kernel name."""
    dem = mangled
    if shutil.which("c++filt"):
        dem = subprocess.run(["c++filt", mangled], capture_output=True, text=True).stdout.strip()
    m = re.search(r"\w+_kernel(<[^()]*>)?", dem.replace("(anonymous namespace)::", ""))
    return m.group(0) if m else dem


def ptxas_report(lib_path: pathlib.Path) -> list:
    """[{kernel, registers, stack, spill_stores, spill_loads}] from the
    ``ptxas -v`` report kept beside a built library."""
    out, cur = [], None
    for line in (lib_path.parent / "ptxas.txt").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"kernel": _short_name(m.group(1))}
            out.append(cur)
        elif cur is not None:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
            if m:
                cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m.group(1))
    return out


def _cuobjdump() -> str:
    return str(pathlib.Path(_build._nvcc()).parent / "cuobjdump")


def sass_functions(binary: pathlib.Path) -> dict:
    """{function: [(address, instruction text)]} of a cubin or library from
    ``cuobjdump -sass``, NOPs dropped."""
    sass = subprocess.run([_cuobjdump(), "-sass", str(binary)], check=True,
                          capture_output=True, text=True).stdout
    funcs, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if cur is not None and m and not m.group(2).startswith("NOP"):
            cur.append((int(m.group(1), 16), m.group(2)))
    return funcs


def _fast_path_length(instrs: list) -> int:
    """Instructions from the start to the first EXIT along the fast path:
    a forward conditional branch over a region that holds a CALL or a
    backward branch (a slow path: a subroutine call, a reduction loop) is
    taken, any other branch falls through. ``instrs``: [(address, text)]."""
    index = {addr: i for i, (addr, _) in enumerate(instrs)}

    def target(i):  # cuobjdump prints branch targets as addresses
        m = re.search(r"BRA\S*\s+0x([0-9a-f]+)", instrs[i][1])
        return index.get(int(m.group(1), 16)) if m else None

    pos, count = 0, 0
    while pos < len(instrs):
        text = instrs[pos][1]
        count += 1
        if text.startswith("EXIT"):
            break
        t = target(pos) if text.startswith("@") else None
        if t is not None and t > pos and any(
                "CALL" in instrs[j][1] or (target(j) is not None and target(j) <= j)
                for j in range(pos + 1, t)):
            pos = t
            continue
        pos += 1
    return count


def sass_costs(work: pathlib.Path) -> dict:
    """Fast-path SASS instructions of one f32 division, sqrtf, rsqrtf,
    powf(|x|, 1/3) and cosf: each probe kernel's instructions up to its
    first EXIT along its fast path, less those of a kernel that only adds;
    with the static count up to EXIT beside them."""
    work.mkdir(parents=True, exist_ok=True)
    src = work / "sass_probe.cu"
    body = {"base": "a[i]", "div": "a[i] / c[i]", "sqrt": "sqrtf(a[i])", "rsqrt": "rsqrtf(a[i])",
            "pow": "powf(fabsf(a[i]), 1.0f / 3.0f)", "cos": "cosf(a[i])"}
    src.write_text("".join(
        f'extern "C" __global__ void probe_{k}(const float* a, const float* c, float* o) '
        f'{{ const int i = threadIdx.x; o[i] = {v} + c[i]; }}\n' for k, v in body.items()))
    cubin = work / "sass_probe.cubin"
    subprocess.run([_build._nvcc(), "-cubin", "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-fmad=true", "-o", str(cubin), str(src)], check=True, capture_output=True)
    funcs = {name.removeprefix("probe_"): ins for name, ins in sass_functions(cubin).items()}
    fast = {k: _fast_path_length(v) for k, v in funcs.items()}
    static = {k: next((i + 1 for i, (_, t) in enumerate(v) if t.startswith("EXIT")), len(v))
              for k, v in funcs.items()}
    return {k: {"fast_path": fast[k] - fast["base"], "to_exit": static[k] - static["base"]}
            for k in funcs if k != "base"}


def sass_mix(lib_path: pathlib.Path) -> dict:
    """{kernel: {"total": n, kind: n, ..., "FFMA": n}}: each kernel's static
    SASS instructions by kind (``SASS_KINDS``), and its FFMAs."""
    kind_of = {op: kind for kind, ops in SASS_KINDS.items() for op in ops}
    out = {}
    for name, ins in sass_functions(lib_path).items():
        counts = dict.fromkeys([*SASS_KINDS, "other"], 0)
        ffma = 0
        for _, text in ins:
            op = re.sub(r"^@!?U?P\w+\s+", "", text).split()[0].split(".")[0]
            counts[kind_of.get(op, "other")] += 1
            ffma += op == "FFMA"
        out[_short_name(name)] = {"total": len(ins), **counts, "FFMA": ffma}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sass-costs", action="store_true")
    ap.add_argument("--sass-mix", action="store_true")
    ap.add_argument("--json", type=pathlib.Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_bench: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    log(f"[device] {smi}")
    result = {"device": smi, "ptxas": {}}
    for name in ("render_fwd", "render_bwd"):
        path = _build.build(name)
        result["ptxas"][name] = ptxas_report(path)
        if args.sass_mix:
            result.setdefault("sass_mix", {})[name] = sass_mix(path)
    if args.sass_costs:
        result["sass_costs"] = sass_costs(_build.BUILD_ROOT / "sass_probe")
    print(json.dumps(result))
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Probe of the compiled kernels: ptxas's registers, shared memory and spills
per kernel, and a census of each kernel's SASS (cuobjdump): instructions,
loop bodies, packed min/max (VIMNMX3), popcounts, shared and local memory.

Run on a machine with the CUDA toolkit:

    python -m orb_slam3_vio_fixes_tpu_torch.sass_census

It compiles `kernels.SOURCES` with the library's flags plus `-Xptxas -v`
into `build/sass/`; the kernel library itself is not touched. It only
prints: a spill costs time, not correctness, so it fails nothing.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess

from orb_slam3_vio_fixes_tpu_torch import kernels

OPS = ("VIMNMX3", "VIMNMX", "IMNMX", "IADD3", "IMAD", "LOP3", "POPC", "SHFL",
       "LDS", "LDGSTS", "ATOMG", "REDG", "STL", "LDL")


def _tool(name: str) -> str:
    return shutil.which(name) or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", name)


def census(sass: str) -> dict:
    """Kernel name -> (instruction count, loop-body lengths, op counts)."""
    funcs, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*)",
                     line)
        if m and name:
            funcs[name].append((int(m.group(1), 16), m.group(3), m.group(4)))
    out = {}
    for name, ins in funcs.items():
        ops = [op.split(".")[0] for _, op, _ in ins]
        # a loop is a branch back to a lower address; its body lies between
        loops = []
        for addr, op, rest in ins:
            t = re.search(r"BRA\s+(?:`\(\S+\)\s*)?0x([0-9a-f]+)", op + rest)
            if op.startswith("BRA") and t and int(t.group(1), 16) < addr:
                lo = int(t.group(1), 16)
                loops.append(sum(1 for a, _, _ in ins if lo <= a <= addr))
        out[name] = (len(ins), loops, {k: ops.count(k) for k in OPS})
    return out


def main() -> None:
    out_dir = kernels.BUILD_DIR.parent / "sass"
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / "libslam_kernels_sass.so"
    proc = subprocess.run(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(so),
         *(str(kernels.CSRC / s) for s in kernels.SOURCES)],
        capture_output=True, text=True, check=True)
    print(proc.stderr.strip())
    sass = subprocess.run([_tool("cuobjdump"), "-sass", str(so)],
                          capture_output=True, text=True, check=True).stdout
    for name, (n, loops, ops) in census(sass).items():
        short = re.sub(r"^.*?_cu_[0-9a-f]{8}\d+", "", name)[:60]
        print(f"[sass] {short}: {n} instructions, loop bodies {loops}, {ops}")


if __name__ == "__main__":
    main()

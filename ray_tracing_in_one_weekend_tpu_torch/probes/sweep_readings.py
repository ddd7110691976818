"""Readings of the three kernels that sweep the scene: `render_kernel`,
`grad_replay_kernel` and `sweep_probe_kernel`.

`readings` gives, for each, its registers and spill bytes (ptxas' report
of the build), its resident blocks an SM at a tile of 128 threads for
the cover scene's 512 slots, and the SASS instructions its sweep loop
issues per sphere test (`cuobjdump -sass` of the built library; "not
available" where the toolkit has no cuobjdump). Blocks an SM come from
the CUDA runtime where the library reports them (`build.blocks_per_sm`),
and from the occupancy rules of an H100 (`blocks_per_sm`) for any build,
a parent's too. chip_smoke.py phase 2 prints them for this checkout,
probes/sweep_variants.py for each variant and for a parent checkout
(`load_build`).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

# Name of each sweep kernel's function, as it appears in its mangled name.
SWEEP_KERNELS = {"render_kernel": "render_kernel", "grad_replay": "grad_replay_kernel",
                 "sweep_probe": "sweep_probe_kernel"}
# Threads a block at the readings' tile (the sweep probe's block is always
# 128), the cover scene's slots, and the shared memory a sphere of the sweep
# table (csrc/render_device.cuh, one float4).
TILE = 128
N_SLOTS = 512
TABLE_BYTES = 16
# Float32 multiplies of one sphere test: d.c 3, c.(-2o) 3, half_b^2 1.
FMUL_PER_TEST = 7


@dataclasses.dataclass
class Resources:
    registers: int = 0
    spill_stores: int = 0  # bytes
    spill_loads: int = 0
    smem: int = 0  # static shared memory, bytes


def ptxas_resources(log: str) -> dict[str, Resources]:
    """Each entry function's registers, spills and static shared memory from
    an nvcc log with ptxas -v, by mangled name."""
    out: dict[str, Resources] = {}
    current = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line) or re.search(
            r"Function properties for (\S+)", line)
        if m:
            current = m.group(1)
            out.setdefault(current, Resources())
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[current].spill_stores, out[current].spill_loads = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[current].registers = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            out[current].smem = int(smem.group(1)) if smem else 0
    return out


def find_kernel(names, kernel: str) -> str | None:
    """The mangled name among `names` of the sweep kernel `kernel`."""
    fn = SWEEP_KERNELS[kernel]
    hits = [n for n in names if n.startswith(f"_Z{len(fn)}{fn}")]
    return hits[0] if hits else None


def blocks_per_sm(registers: int, smem_per_block: int, threads: int) -> int:
    """Resident blocks an H100 SM holds (compute capability 9.0): 2048
    threads, 32 blocks, 65536 registers allocated 256 a warp, 228 KB of
    shared memory with 1 KB reserved for each block."""
    warps = -(-threads // 32)
    by_threads = min(32, 64 // warps)
    regs_per_warp = -(-max(registers, 1) * 32 // 256) * 256
    by_regs = (65536 // regs_per_warp) // warps
    by_smem = 233472 // (smem_per_block + 1024)
    return min(by_threads, by_regs, by_smem)


# ---------------------------------------------------------------------------
# SASS: the sweep loop's instructions per sphere test.
# ---------------------------------------------------------------------------

_INSN = re.compile(r"/\*([0-9a-fA-F]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)(\.[A-Z0-9_.]+)?\s*([^;]*);")
_LABEL = re.compile(r"^\s*(\.L\w+):")


def sass_functions(text: str) -> dict[str, str]:
    """`cuobjdump -sass` output -> {function name: its listing}."""
    out: dict[str, str] = {}
    name = None
    for line in text.splitlines():
        m = re.match(r"\s*Function\s*:\s*(\S+)", line)
        if m:
            name = m.group(1)
            out[name] = ""
        elif name is not None:
            out[name] += line + "\n"
    return out


def _instructions(listing: str):
    """[(address, opcode, modifiers, operands, branch target or None)]."""
    insns, labels, pending = [], {}, []
    for line in listing.splitlines():
        lab = _LABEL.match(line)
        if lab:
            pending.append(lab.group(1))
            continue
        m = _INSN.search(line)
        if not m:
            continue
        addr = int(m.group(1), 16)
        for lab in pending:
            labels[lab] = addr
        pending = []
        insns.append([addr, m.group(2), m.group(3) or "", m.group(4).strip(), None])
    for ins in insns:
        if ins[1] == "BRA":
            hexa = re.search(r"0x([0-9a-fA-F]+)\s*$", ins[3])
            label = re.search(r"(\.L\w+)", ins[3])
            ins[4] = int(hexa.group(1), 16) if hexa else labels.get(label.group(1)) if label else None
    return insns


@dataclasses.dataclass
class SweepLoop:
    instructions: int  # issued on one trip through the loop when no test has a real root
    tests: float  # sphere tests a trip: its float32 multiplies / FMUL_PER_TEST
    opcodes: dict

    @property
    def per_test(self) -> float:
        return self.instructions / self.tests


def sweep_loop(listing: str) -> SweepLoop | None:
    """The sweep loop of one kernel's SASS and its instructions per sphere
    test. A loop is a backward branch and the span it closes. A trip's
    instructions are the span's, less those a forward branch within the
    span jumps over (the roots, taken only when a test has real roots);
    predicated instructions count, as they take an issue slot. The sweep
    loop is the loop with the most such FMULs (7 a test) among the loops
    of at least one test that enclose no other such loop."""
    insns = [i for i in _instructions(listing) if i[1] != "NOP"]
    loops = []
    for k, (addr, op, _, _, target) in enumerate(insns):
        if op == "BRA" and target is not None and target <= addr:
            lo = next(j for j, i in enumerate(insns) if i[0] >= target)
            body = insns[lo:k + 1]
            skipped = set()
            for j, i in enumerate(body):
                if i[1] == "BRA" and i[4] is not None and i[0] < i[4] <= addr:
                    skipped.update(x[0] for x in body[j + 1:] if x[0] < i[4])
            hot = [i for i in body if i[0] not in skipped]
            fmul = sum(1 for i in hot if i[1] == "FMUL")
            if fmul >= FMUL_PER_TEST:
                loops.append((target, addr, hot, fmul))
    inner = [lp for lp in loops
             if not any(o is not lp and lp[0] <= o[0] and o[1] <= lp[1] for o in loops)]
    if not inner:
        return None
    _, _, hot, fmul = max(inner, key=lambda lp: lp[3])
    opcodes: dict[str, int] = {}
    for i in hot:
        opcodes[i[1]] = opcodes.get(i[1], 0) + 1
    return SweepLoop(len(hot), fmul / FMUL_PER_TEST, opcodes)


def _cuobjdump() -> str | None:
    found = shutil.which("cuobjdump")
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump"
    return found or (str(default) if default.exists() else None)


def sass_of(lib: Path) -> str | None:
    """`cuobjdump -sass` of a built library, or None without cuobjdump."""
    tool = _cuobjdump()
    if tool is None:
        return None
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, timeout=300)
    return out.stdout if out.returncode == 0 else None


# ---------------------------------------------------------------------------
# Readings.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Reading:
    kernel: str
    resources: Resources | None
    blocks_per_sm: int | None  # the CUDA runtime's, where the library reports it
    blocks_per_sm_rules: int | None  # the occupancy rules' (`blocks_per_sm`)
    loop: SweepLoop | None
    sass: bool  # whether cuobjdump was available

    def line(self) -> str:
        r = self.resources
        res = (f"{r.registers} registers, spills {r.spill_stores} B stored / {r.spill_loads} B loaded"
               if r else "registers not reported")
        blocks = "; ".join(x for x in (
            f"{self.blocks_per_sm} (CUDA runtime)" if self.blocks_per_sm is not None else "",
            f"{self.blocks_per_sm_rules} (occupancy rules)" if self.blocks_per_sm_rules is not None else "",
        ) if x) or "not available"
        if not self.sass:
            sass = "SASS per sphere test: not available (no cuobjdump)"
        elif self.loop is None:
            sass = "SASS per sphere test: sweep loop not found"
        else:
            top = ", ".join(f"{k} {v}" for k, v in sorted(self.loop.opcodes.items(), key=lambda kv: -kv[1])[:8])
            sass = (f"SASS per sphere test {self.loop.per_test:.2f} ({self.loop.instructions} instructions "
                    f"a trip, {self.loop.tests:g} tests a trip: {top})")
        return f"{self.kernel}: {res}; blocks per SM at tile {TILE}: {blocks}; {sass}"

    def fields(self) -> dict:
        """The reading as keys of chip_smoke.py's `kernels` line."""
        r = self.resources
        return {"registers": r.registers if r else None,
                "spill_bytes": r.spill_stores + r.spill_loads if r else None,
                "blocks_per_sm_tile128": self.blocks_per_sm,
                "sass_per_sphere_test": self.loop.per_test if self.loop else "not available"}


def readings(log: str, lib_path: Path, table_bytes: int, runtime=None) -> list[Reading]:
    """The readings of the three sweep kernels of a built library. `log`:
    its nvcc log (ptxas -v); `table_bytes`: shared memory a sphere of the
    kernels' sweep table; `runtime(kernel)`: the CUDA runtime's blocks an
    SM, or None."""
    res = ptxas_resources(log)
    sass = sass_of(lib_path)
    funcs = sass_functions(sass) if sass else {}
    out = []
    for kernel in SWEEP_KERNELS:
        name = find_kernel(res, kernel)
        r = res.get(name) if name else None
        rules = None
        if r is not None:
            rules = blocks_per_sm(r.registers, r.smem + table_bytes * N_SLOTS, TILE)
        fname = find_kernel(funcs, kernel)
        loop = sweep_loop(funcs[fname]) if fname else None
        out.append(Reading(kernel, r, runtime(kernel) if runtime else None, rules, loop, sass is not None))
    return out


def load_build(root: Path):
    """The `kernels/build.py` module of the checkout at `root`."""
    path = root / "ray_tracing_in_one_weekend_tpu_torch" / "kernels" / "build.py"
    spec = importlib.util.spec_from_file_location(f"_build_{abs(hash(str(root)))}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # its dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod

"""Print the loops of a built kernel's SASS, with their instruction counts.

  python3 tools/sass_loops.py rolling [--match rolling_kernelILi1E] [--out DIR]

Builds ``src/repro_torch/kernels/csrc/<name>.cu`` (or the ``.cu`` path
given) as the port does, disassembles the library with ``cuobjdump -sass``
and, for every kernel whose mangled name holds ``--match``, lists each loop
(a branch back to an earlier instruction): its first and last address,
its instruction count and its opcodes by count. An inner loop is listed
inside the loops that hold it, so a loop's count per trip is its own
count less those of the loops it holds, times their trips. The whole SASS
goes to ``DIR/<name>.sass`` (default ``build/sass``). Needs the CUDA
toolkit; exits 2 without ``nvcc``.
"""
import argparse
import collections
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402

_FUNC = re.compile(r"^\s*Function : (\S+)")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET = re.compile(r"\bBRA\b(?:\.\S+)?.*?(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))")


def parse(sass: str) -> dict:
    """{function: [(address, instruction text)]} and each label's address."""
    funcs, cur, pending = {}, None, []
    labels = {}
    for line in sass.splitlines():
        m = _FUNC.match(line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _LABEL.match(line)
        if m and cur is not None:
            pending.append(m.group(1))
            continue
        m = _INSN.search(line)
        if m and cur is not None:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[(id(cur), lab)] = addr
            pending = []
            cur.append((addr, m.group(2)))
    return funcs, labels


def loops(insns, labels, key) -> list:
    """[(start, end, count, opcode Counter)] for each backward branch."""
    out = []
    for addr, text in insns:
        m = _TARGET.search(text)
        if not m:
            continue
        tgt = (labels.get((key, m.group(1))) if m.group(1)
               else int(m.group(2), 16))
        if tgt is None or tgt > addr:
            continue
        body = [t for a, t in insns if tgt <= a <= addr]
        ops = collections.Counter(
            t.split()[1] if t.startswith("@") else t.split()[0]
            for t in body)
        out.append((tgt, addr, len(body), ops))
    return sorted(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("name")
    ap.add_argument("--match", default="")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "sass")
    args = ap.parse_args(argv)
    try:
        nvcc = _build.nvcc()
    except RuntimeError as e:
        print(f"sass_loops: {e}", file=sys.stderr)
        return 2
    lib = _build._compile(args.name)
    dump = shutil.which("cuobjdump") or str(Path(nvcc).parent / "cuobjdump")
    sass = subprocess.run([dump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    args.out.mkdir(parents=True, exist_ok=True)
    stem = Path(args.name).stem
    (args.out / f"{stem}.sass").write_text(sass)
    funcs, labels = parse(sass)
    for fn, insns in funcs.items():
        if args.match not in fn:
            continue
        print(f"sass[{stem}] {fn}: {len(insns)} instructions")
        for start, end, count, ops in loops(insns, labels, id(insns)):
            top = ", ".join(f"{op} {c}" for op, c in ops.most_common())
            print(f"  loop {start:#06x}-{end:#06x}: {count} instructions: "
                  f"{top}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

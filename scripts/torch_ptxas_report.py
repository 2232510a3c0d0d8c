#!/usr/bin/env python3
"""What ptxas says of each kernel in a CUDA source of the port: registers,
stack frame, spills, and its notes on wgmma.

    python3 scripts/torch_ptxas_report.py SOURCE.cu [extra nvcc flags ...]

Compiles SOURCE.cu for sm_90a with the port's flags (ops/cuda_build.py) plus
the extra ones into a temporary file and prints one line per kernel. Needs
nvcc; no GPU. Example: the same source with and without `--use_fast_math`
shows whether a stack frame comes from the slow paths of expf and of the
IEEE division rather than from register pressure.
"""
import re
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from mm_distillnet_torch.ops import cuda_build  # noqa: E402


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__)
        return 2
    source, extra = sys.argv[1], sys.argv[2:]
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, *extra, '-o',
               str(Path(tmp) / 'out.so'), source]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        print(proc.stdout)
        return 1
    name = None
    for line in proc.stdout.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            full = subprocess.run(['c++filt', m.group(1)], capture_output=True,
                                  text=True).stdout.strip()
            short = re.search(r'(\w+(<[^>]*>)?)\(', full.replace(
                '(anonymous namespace)::', ''))
            name = short.group(1) if short else full
        elif 'bytes stack frame' in line:
            frame = line.strip()
        elif 'Used' in line and name:
            print(f'{name}: {frame}; {line.split(":", 1)[1].strip()}')
            name = None
    notes = {}
    for code in re.findall(r'\((C75\d\d)\)', proc.stdout):
        notes[code] = notes.get(code, 0) + 1
    print('ptxas notes:', notes, '| extra flags:', extra)
    return 0


if __name__ == '__main__':
    sys.exit(main())

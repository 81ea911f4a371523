"""CLI trace-schema validator (the CI trace-artifact gate).

  PYTHONPATH=src python -m repro_torch.obs.validate trace.json [more.json ...]

Exits non-zero and prints every schema problem if any file fails."""
from __future__ import annotations

import sys

from repro_torch.obs.export import validate_chrome_trace_file


def main(argv: list[str]) -> int:
    if not argv:
        print("usage: python -m repro_torch.obs.validate TRACE.json [...]",
              file=sys.stderr)
        return 2
    bad = 0
    for path in argv:
        problems = validate_chrome_trace_file(path)
        if problems:
            bad += 1
            print(f"INVALID {path}:")
            for p in problems:
                print(f"  - {p}")
        else:
            print(f"ok {path}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

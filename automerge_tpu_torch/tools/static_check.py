"""The port's static gate.

Runs the four `automerge_tpu_torch.analysis` checkers -- env-latch,
telemetry-key, dispatch-alias, lock-discipline -- over
`automerge_tpu_torch/`, then a generic Python lint of the port (ruff or
pyflakes, whichever is installed; skipped with a note otherwise).

Exit code 1 on any finding.  Usage, from the repo root:

    python -m automerge_tpu_torch.tools.static_check            # all
    python -m automerge_tpu_torch.tools.static_check --only env-latch
    python -m automerge_tpu_torch.tools.static_check --extra path/to/x.py
    python -m automerge_tpu_torch.tools.static_check --no-lint
"""

import argparse
import os
import shutil
import subprocess
import sys

from ..analysis import run_checks
from ..analysis.engine import CHECKERS, DEFAULT_SCAN_DIRS

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run_generic_lint():
    """The ruff or pyflakes baseline over the port; returns
    (finding_count, label), the label naming what ran."""
    targets = [os.path.join(ROOT, d) for d in DEFAULT_SCAN_DIRS]
    if shutil.which('ruff'):
        cmd, label = ['ruff', 'check'] + targets, 'ruff'
    else:
        try:
            import pyflakes  # noqa: F401
        except ImportError:
            print('static-check: generic lint skipped (neither ruff nor '
                  'pyflakes is installed; the project checkers still '
                  'gate)', file=sys.stderr)
            return 0, 'lint skipped'
        cmd = [sys.executable, '-m', 'pyflakes'] + targets
        label = 'pyflakes'
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
    out = (proc.stdout + proc.stderr).strip()
    if proc.returncode != 0:
        # a failing linter with empty output is still a failure
        print(out or ('static-check: %s exited %d with no output'
                      % (label, proc.returncode)))
        return max(1, out.count('\n') + 1), label
    return 0, label


def main(argv=None):
    from ..analysis import (  # noqa: F401  (registers the checkers)
        check_alias, check_env, check_locks, check_telemetry)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--only', action='append', default=None,
                    metavar='CHECKER',
                    help='run only this checker (repeatable); known: %s'
                    % ', '.join(sorted(CHECKERS)))
    ap.add_argument('--extra', action='append', default=[],
                    metavar='FILE',
                    help='additionally scan this file')
    ap.add_argument('--no-lint', action='store_true',
                    help='skip the generic ruff/pyflakes baseline')
    args = ap.parse_args(argv)

    try:
        findings = run_checks(ROOT, checkers=args.only,
                              extra_files=args.extra)
    except ValueError as e:
        print('static-check: %s' % e, file=sys.stderr)
        return 2
    for f in findings:
        print(f.format(ROOT))
    n_lint, lint_label = (0, None) if (args.no_lint or args.only) \
        else run_generic_lint()
    total = len(findings) + n_lint
    if total:
        print('static-check: FAIL (%d finding%s)'
              % (total, '' if total == 1 else 's'))
        return 1
    print('static-check: PASS (%d checkers%s)'
          % (len(args.only or CHECKERS),
             '' if lint_label is None else ' + %s' % lint_label))
    return 0


if __name__ == '__main__':
    sys.exit(main())

"""One build cache for the package's compiled libraries.

A library is named by a hash of its sources and compiler command, so an
edited source or flag builds a new file.  A file lock serializes
concurrent builds of one library (test workers, the parallel kernel
builds), and the compiler writes a temporary file that is renamed into
place only once complete, so no process ever loads a half-written
library.  A failed build raises.

`start` launches the compiler and returns at once; `finish` waits for it.
Starting several builds before finishing any runs them in parallel.
"""

import fcntl
import hashlib
import os
import subprocess

#: the repository root; the build outputs live under build/ there
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_ROOT = os.path.join(ROOT, 'build', 'automerge_tpu_torch')


def artifact(build_dir, stem, sources, flags):
    """`<build_dir>/<stem>-<hash>.so`, the hash over flags and sources."""
    h = hashlib.sha256(' '.join(flags).encode())
    for src in sources:
        with open(src, 'rb') as f:
            h.update(f.read())
    return os.path.join(build_dir, '%s-%s.so' % (stem, h.hexdigest()[:16]))


class _Build:
    def __init__(self, path, what, proc=None, tmp=None, lock=None):
        self.path, self.what = path, what
        self.proc, self.tmp, self.lock = proc, tmp, lock


def start(path, command, what):
    """Starts building `path` unless it exists.  `command(out)` is the
    compiler's argv writing to `out`; `what` names the build in errors."""
    if os.path.exists(path):
        return _Build(path, what)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    lock = open(path + '.lock', 'w')
    fcntl.flock(lock, fcntl.LOCK_EX)
    if os.path.exists(path):
        lock.close()
        return _Build(path, what)
    tmp = '%s.%d.tmp' % (path, os.getpid())
    try:
        proc = subprocess.Popen(command(tmp), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT)
    except BaseException:
        lock.close()
        raise
    return _Build(path, what, proc, tmp, lock)


def finish(build):
    """Waits for a started build; returns the library's path."""
    if build.proc is None:
        return build.path
    try:
        out, _ = build.proc.communicate()
        if build.proc.returncode != 0:
            raise RuntimeError('build of %s failed:\n%s'
                               % (build.what, out.decode(errors='replace')))
        os.replace(build.tmp, build.path)
    finally:
        build.lock.close()
    return build.path

"""Server subprocesses of the port: spawn-and-wait and one teardown
ladder.

`spawn_server` starts ``python -m automerge_tpu_torch.sidecar.server
--socket PATH --device DEVICE`` (the card unless the caller asks for
'cpu') and waits for its socket; a server that exits first (no CUDA
device, a kernel that does not build) raises.  Every caller that
SIGKILLs or respawns servers tears the whole set down through
`stop_server` / `stop_all`: an orphaned server holding its unix socket
makes the next run flaky.
"""

import os
import subprocess
import sys
import time

from ..sidecar.client import SERVER_MODULE

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def server_argv(path, device='cuda', args=()):
    """The command line of one port server on socket `path`."""
    return [sys.executable, '-m', SERVER_MODULE, '--socket', path,
            '--device', device] + list(args)


def start_server(path, device='cuda', args=(), cwd=None):
    """Starts one port server on `path` without waiting for it.  `args`
    are more server flags (``--replica-id``, ``--metrics-port``,
    ``--storage-dir``...)."""
    if os.path.exists(path):
        os.unlink(path)           # a stale socket from a killed process
    full_env = dict(os.environ)
    full_env['PYTHONPATH'] = REPO + os.pathsep \
        + full_env.get('PYTHONPATH', '')
    return subprocess.Popen(server_argv(path, device, args), env=full_env,
                            cwd=cwd, stdin=subprocess.DEVNULL)


def wait_server(proc, path, deadline_s=60.0):
    """Waits until `proc` has bound `path`; raises (reaping the child)
    when it exits first or the deadline passes."""
    deadline = time.monotonic() + deadline_s
    while not os.path.exists(path):
        if time.monotonic() > deadline or proc.poll() is not None:
            stop_server(proc)
            raise RuntimeError('server on %s did not come up (rc=%s)'
                               % (path, proc.returncode))
        time.sleep(0.02)
    return proc


def spawn_server(path, device='cuda', args=(), deadline_s=60.0, cwd=None):
    """Spawns one port server on `path` and waits for its socket (or
    raises, reaping the child)."""
    return wait_server(start_server(path, device, args, cwd), path,
                       deadline_s)


def spawn_servers(specs, device='cuda', deadline_s=60.0, cwd=None):
    """Starts one server per `(path, args)` of `specs` at once, then
    waits for every socket: {path: proc}.  A server that does not come
    up tears all of them down and raises."""
    procs = {path: start_server(path, device, args, cwd)
             for path, args in specs}
    try:
        for path, proc in procs.items():
            wait_server(proc, path, deadline_s)
    except RuntimeError:
        stop_all(procs)
        raise
    return procs


def stop_server(proc, timeout=30):
    """terminate -> wait -> kill -> wait.  Safe on a dead process."""
    if proc is None or proc.poll() is not None:
        return
    try:
        proc.terminate()
    except OSError:
        pass
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        try:
            proc.kill()
        except OSError:
            pass
        try:
            proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            pass


def stop_all(procs):
    """Tears down every process in a dict or list, never raising."""
    vals = procs.values() if hasattr(procs, 'values') else procs
    for proc in list(vals):
        try:
            stop_server(proc)
        except Exception:
            pass

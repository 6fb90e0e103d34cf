"""The device trace of a `--trace 1` run: `torch.profiler` over the
window, read back from its Chrome trace.

* the window: from the start of the first `bench.call` range (the
  benchmark's `record_function` around each timed call) to the end of
  the last;
* busy: the union of the card's kernels, copies and fills inside it;
* the port's kernels: kernels whose name is a `__global__` function of
  the port's CUDA sources (`automerge_tpu_torch/csrc/*.cu`);
* idle gaps: the stretches of the window with nothing on the card, each
  named by the innermost host range or op that held the gap's middle.
"""

import glob
import json
import os
import re
import tempfile

CALL_RANGE = 'bench.call'
_DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
_HOST_CATS = ('cpu_op', 'user_annotation')
_GLOBAL_RE = re.compile(
    r'__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(')


def port_kernel_names(csrc_dir):
    names = set()
    for path in glob.glob(os.path.join(csrc_dir, '*.cu')):
        with open(path) as f:
            names.update(_GLOBAL_RE.findall(f.read()))
    return names


def base_name(kernel):
    """`void (anonymous namespace)::grid_kernel<4>(int*, ...)` ->
    `grid_kernel`."""
    name = kernel.replace('(anonymous namespace)::', '')
    if name.startswith('void '):
        name = name[5:]
    name = re.split(r'[(<]', name, 1)[0]
    return name.rsplit('::', 1)[-1].strip()


def start():
    import torch
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


def stop(prof):
    prof.__exit__(None, None, None)


def events_of(prof):
    """The Chrome trace's events, by way of a file in the temporary
    directory that is removed once read."""
    fd, path = tempfile.mkstemp(prefix='benchmark-trace-', suffix='.json')
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)['traceEvents']
    finally:
        os.remove(path)


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def summarize(events, port_kernels, top=10):
    """{'window_s', 'busy_s', 'kernel_s', 'device_ops', 'idle_gaps'}
    of one traced window, or None where the trace holds no call."""
    calls = [e for e in events if e.get('name') == CALL_RANGE
             and e.get('cat') == 'user_annotation' and 'dur' in e]
    if not calls:
        return None
    w0 = min(e['ts'] for e in calls)
    w1 = max(e['ts'] + e['dur'] for e in calls)
    device, host = [], []
    by_name = {}
    kernel_us = 0.0
    for e in events:
        cat = e.get('cat')
        if 'dur' not in e or e.get('ph') != 'X':
            continue
        a, b = e['ts'], e['ts'] + e['dur']
        if cat in _DEVICE_CATS:
            a, b = max(a, w0), min(b, w1)
            if b <= a:
                continue
            device.append((a, b))
            name = base_name(e['name']) if cat == 'kernel' else e['name']
            by_name[name] = by_name.get(name, 0.0) + (b - a)
            if cat == 'kernel' and name in port_kernels:
                kernel_us += b - a
        elif cat in _HOST_CATS:
            host.append((a, b, e['name']))
    busy = _union(device)
    busy_us = sum(b - a for a, b in busy)
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    gaps.sort(key=lambda g: g[0] - g[1])
    idle = []
    for a, b in gaps[:top]:
        mid = (a + b) / 2
        holders = [(hb - ha, name) for ha, hb, name in host
                   if ha <= mid <= hb]
        idle.append([min(holders)[1] if holders else 'between calls',
                     (b - a) / 1e6])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {'window_s': (w1 - w0) / 1e6, 'busy_s': busy_us / 1e6,
            'kernel_s': kernel_us / 1e6,
            'device_ops': [[n, us / 1e6] for n, us in ops],
            'idle_gaps': idle}

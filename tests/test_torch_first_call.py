"""The port's kernels are safe to call for the first time from several
threads at once.

A mesh pool runs one thread a chip, and on a one-card host every chip is
`cuda:0`, so the threads reach each kernel's first call together.  What
a first call fills must be filled once and seen whole:

- the Python caches: `_build.kernel` loads each kernel library once,
  `dominance_kernel`'s branch counters are one tensor a device, and
  `native._lib.lib()` loads the C++ core once (16 threads behind a
  barrier, the loads slowed so that a check outside the lock would race);
- the kernels' host code: a scan of `automerge_tpu_torch/csrc/*.cu`
  finds every mutable host variable at namespace scope (and every static
  local of a function) and holds it to one pattern: its type is a
  `std::atomic`, a `std::once_flag` or a `std::mutex`, or its
  declaration carries `// guarded-by: <lock>` naming such a variable of
  the same file (the grammar of the port's Python lock-discipline
  checker).  Device variables (`__device__`, `__constant__`,
  `__shared__`) are the card's, not the host's, and are not scanned;
- the kernels' attributes: a `cudaFuncSetAttribute` sets state of the
  function, shared by every thread that launches it, so the scan holds
  each one's value to constants (`kSmemMax`, `P::kBytes`,
  `tile_bytes<kDigitBits>(kTileMax)`): no call's own shape, which a
  thread could set between another thread's set and its launch.

The card runs the same first calls in fresh processes: `chip_smoke.py`'s
first-call lane."""

import glob
import os
import re
import sys
import threading
import time

import pytest
import torch

from automerge_tpu_torch import buildcache
from automerge_tpu_torch.native import _lib as native_lib
from automerge_tpu_torch.ops import _build, dominance_kernel
from torch_threads import cap_threads

cap_threads()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, 'automerge_tpu_torch', 'csrc')
SOURCES = sorted(glob.glob(os.path.join(CSRC, '*.cu')))
THREADS = 16
#: how long a stubbed load takes: long enough that every thread has
#: passed an unlocked check before the first load returns
LOAD_S = 0.05


def _together(fn, n=THREADS):
    """fn() on n threads released together by a barrier, the interpreter
    switching threads every microsecond; their results."""
    barrier = threading.Barrier(n)
    out, errors = [None] * n, []

    def run(i):
        try:
            barrier.wait(30)
            out[i] = fn()
        except Exception as e:
            errors.append(e)
    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not errors, errors
    assert not any(t.is_alive() for t in threads)
    return out


class _Counting:
    """A stub that counts its calls, each taking LOAD_S, and returns
    make(*args)."""

    def __init__(self, make):
        self.make, self.calls = make, 0
        self._lock = threading.Lock()

    def __call__(self, *args, **kw):
        with self._lock:
            self.calls += 1
        time.sleep(LOAD_S)
        return self.make(*args, **kw)


class _FakeLib:
    """A loaded library: any entry point, each with settable types."""

    def __getattr__(self, name):
        fn = type('Fn', (), {})()
        object.__setattr__(self, name, fn)
        return fn


@pytest.mark.parametrize('name', sorted(_build.KERNELS))
def test_kernel_library_loads_once(monkeypatch, name):
    """16 threads asking for one kernel library at once load it once and
    all get the same library, its entry points typed."""
    monkeypatch.setattr(_build, '_loaded', {})
    monkeypatch.setattr(buildcache, 'start',
                        lambda path, command, what: path)
    finish = _Counting(lambda build: build)
    cdll = _Counting(lambda path: _FakeLib())
    monkeypatch.setattr(buildcache, 'finish', finish)
    monkeypatch.setattr(_build.ctypes, 'CDLL', cdll)
    libs = _together(lambda: _build.kernel(name))
    assert cdll.calls == 1 and finish.calls == 1
    assert all(lib is libs[0] for lib in libs)
    for fn_name, (restype, argtypes) in _build.KERNELS[name].items():
        fn = getattr(libs[0], fn_name)
        assert fn.restype is restype and fn.argtypes == argtypes
    assert _build.kernel(name) is libs[0] and cdll.calls == 1


@pytest.mark.parametrize('counts', ['branch_counts', 'block_branch_counts'])
def test_branch_counters_made_once(monkeypatch, counts):
    """16 threads asking for a device's branch counters at once get one
    zeroed int64 [2] tensor, the same for all, made once."""
    monkeypatch.setattr(dominance_kernel, '_BRANCH_COUNTS', {})
    monkeypatch.setattr(dominance_kernel, '_BLOCK_BRANCH_COUNTS', {})
    zeros = _Counting(torch.zeros)
    monkeypatch.setattr(dominance_kernel.torch, 'zeros', zeros)
    got = _together(lambda: getattr(dominance_kernel, counts)('cpu'))
    assert zeros.calls == 1
    assert all(t is got[0] for t in got)
    assert got[0].dtype == torch.int64 and got[0].tolist() == [0, 0]
    assert getattr(dominance_kernel, counts)(torch.device('cpu')) is got[0]


def test_core_library_loads_once(monkeypatch):
    """16 threads reaching the C++ core's first call at once load it
    once."""
    monkeypatch.setattr(native_lib, '_lib', None)
    load = _Counting(lambda: object())
    monkeypatch.setattr(native_lib, '_load', load)
    libs = _together(native_lib.lib)
    assert load.calls == 1 and all(lib is libs[0] for lib in libs)


# -- the kernels' host state ----------------------------------------------

#: types whose objects are safe to share as they stand
_GUARD_TYPE = re.compile(r'^(?:(?:static|inline|thread_local)\s+)*'
                         r'(std::(?:atomic|atomic_flag|once_flag|mutex))\b')
_GUARDED_BY = re.compile(r'//\s*guarded-by:\s*(\w+)')
_SKIP = re.compile(r'^(?:template|using|typedef|static_assert|namespace|'
                   r'friend)\b')
_TYPE_ONLY = re.compile(r'^(?:struct|class|union|enum)\b[^{=(]*(?:\{\})?$')
_DEVICE = re.compile(r'\b__(?:device|constant|shared)__\b')


def _blank(src):
    """The source with comments, the insides of string and character
    literals and preprocessor lines blanked; newlines stay, so a
    character keeps its line."""
    out, i, n = [], 0, len(src)
    while i < n:
        c = src[i]
        if src.startswith('//', i):
            j = src.find('\n', i)
            j = n if j < 0 else j
            out.append(' ' * (j - i))
            i = j
        elif src.startswith('/*', i):
            j = src.find('*/', i + 2)
            j = n if j < 0 else j + 2
            out.append(re.sub(r'[^\n]', ' ', src[i:j]))
            i = j
        elif c in '"\'':
            j = i + 1
            while j < n and src[j] != c:
                j += 2 if src[j] == '\\' else 1
            out.append(c + re.sub(r'[^\n]', ' ', src[i + 1:j]) + c)
            i = j + 1
        else:
            out.append(c)
            i += 1
    lines = ''.join(out).split('\n')
    cont = False
    for k, line in enumerate(lines):
        if cont or line.lstrip().startswith('#'):
            cont = line.rstrip().endswith('\\')
            lines[k] = ''
    return '\n'.join(lines)


def _brace_kind(head):
    """What a `{` opens at namespace scope, from the text before it."""
    h = head.strip()
    if re.search(r'\bnamespace(?:\s+\w+)?\s*$', h) or \
            re.search(r'\bextern\s*"[^"]*"\s*$', h):
        return 'namespace'
    if re.search(r'\)\s*(?:const\s*)?(?:noexcept\s*)?(?:->\s*[\w:<>*&\s]+)?$',
                 h):
        return 'function'
    if re.match(r'^(?:template\s*<.*>\s*)?(?:struct|class|union|enum)\b', h,
                re.S):
        return 'type'
    return 'initializer'


def _statements(code):
    """(text, first line, last line, where) for each declaration at
    namespace scope ('namespace') and each statement of a function body
    that starts with `static` ('local'); a type's or an initializer's
    braces collapse to `{}`."""
    stack, text, first, line = [], [], None, 1
    local, local_first = [], None
    out = []

    def at_namespace():
        return all(k == 'namespace' for k in stack)

    def emit(buf, start, where):
        s = ' '.join(''.join(buf).split())
        if s:
            out.append((s, start, line, where))

    for c in code:
        if at_namespace():
            if c == '{':
                kind = _brace_kind(''.join(text))
                stack.append(kind)
                if kind == 'namespace':
                    text, first = [], None
                elif kind != 'function':
                    text.append('{')
            elif c == '}':
                stack.pop()
                text, first = [], None
            elif c == ';':
                emit(text, first, 'namespace')
                text, first = [], None
            else:
                if first is None and not c.isspace():
                    first = line
                text.append(c)
        elif 'function' in stack:
            if c in '{};':
                s = ''.join(local).strip()
                if re.match(r'static\s', s):
                    emit(local, local_first, 'local')
                local, local_first = [], None
                if c == '{':
                    stack.append('block')
                elif c == '}':
                    stack.pop()
                    if at_namespace():
                        text, first = [], None
            else:
                if local_first is None and not c.isspace():
                    local_first = line
                local.append(c)
        else:
            if c == '{':
                stack.append('inner')
            elif c == '}':
                stack.pop()
                if at_namespace():
                    text.append('}')
        if c == '\n':
            line += 1
    assert not stack, 'unbalanced braces'
    return out


def _variable(s):
    """(name, type pattern or None) when statement `s` declares a mutable
    host variable, else None."""
    if _SKIP.match(s) or _TYPE_ONLY.match(s) or _DEVICE.search(s):
        return None
    decl = s.split('=')[0]
    if '(' in decl:
        return None     # a function's declaration
    if re.search(r'\bconstexpr\b', decl) or (
            re.match(r'^(?:(?:static|inline|extern)\s+)*const\b', decl)
            and not re.search(r'\*(?!\s*const\b)', decl)):
        return None
    name = re.search(r'(\w+)\s*(?:\[[^\]]*\]\s*)*(?:\{\})?\s*$', decl.strip())
    if name is None:
        return None
    guard = _GUARD_TYPE.match(s)
    return name.group(1), guard.group(1) if guard else None


def host_state(path):
    """[(name, line, pattern, problem or None)] of every mutable host
    variable of a CUDA source: pattern is the guarding type, or
    'guarded-by: <lock>'."""
    with open(path) as f:
        src = f.read()
    lines = src.split('\n')
    found = []
    for s, first, last, where in _statements(_blank(src)):
        var = _variable(s)
        if var is None:
            continue
        name, pattern = var
        if where == 'local':
            name = 'static local ' + name
        if pattern is None:
            # the declaration's own lines, and a comment line just above
            above = first > 1 and lines[first - 2].lstrip().startswith('//')
            notes = [_GUARDED_BY.search(lines[k - 1])
                     for k in range(first - 1 if above else first, last + 1)]
            lock = next((m.group(1) for m in notes if m), None)
            pattern = None if lock is None else 'guarded-by: ' + lock
        found.append([name, first, pattern, None])
    locks = {name for name, _, p, _ in found
             if p and not p.startswith('guarded-by')}
    for entry in found:
        name, first, pattern, _ = entry
        if pattern is None:
            entry[3] = ('%s (line %d) is mutable host state with no '
                        'std::atomic, std::once_flag or std::mutex and no '
                        '`// guarded-by: <lock>`' % (name, first))
        elif pattern.startswith('guarded-by') and \
                pattern.split()[-1] not in locks:
            entry[3] = ('%s (line %d) is guarded by %s, which is no '
                        'std::mutex, std::once_flag or std::atomic of the '
                        'file' % (name, first, pattern.split()[-1]))
    return [tuple(e) for e in found]


def test_every_kernel_source_is_scanned():
    assert [os.path.basename(p) for p in SOURCES] == [
        'clock.cu', 'dominance.cu', 'dominance_block.cu',
        'dominance_indexes.cu', 'lexsort.cu', 'linearize.cu', 'members.cu',
        'registers.cu']


@pytest.mark.parametrize('path', SOURCES, ids=os.path.basename)
def test_kernel_host_state_is_guarded(path):
    """Every mutable host variable of the source is a std::atomic, a
    std::once_flag or a std::mutex, or is guarded by one (the entry
    points run on the mesh pool's chip threads at once)."""
    problems = [p for *_, p in host_state(path) if p]
    assert not problems, problems


@pytest.mark.parametrize('name, state', [
    ('lexsort.cu', {'g_state_mutex': 'std::mutex', 'g_ready': 'std::atomic',
                    'g_state': 'guarded-by: g_state_mutex'}),
    ('linearize.cu', {'g_state_mutex': 'std::mutex',
                      'g_ready': 'std::atomic',
                      'g_grid_blocks': 'guarded-by: g_state_mutex'}),
    ('dominance.cu', {}),
    ('dominance_indexes.cu', {}),
    ('dominance_block.cu', {}),
    ('clock.cu', {}),
    ('members.cu', {}),
    ('registers.cu', {}),
])
def test_scan_finds_the_per_device_state(name, state):
    """The scan sees the state the kernels keep: the once-per-device
    state of the two cooperative kernels, and nothing else."""
    got = {n: p for n, _, p, _ in host_state(os.path.join(CSRC, name))}
    assert got == state


#: sources the scan must refuse, and the variables it names
_RACY = [
    ('the flags of a first call, unguarded', '''
namespace {
bool g_smem_set[64];
int g_grid_blocks[64];
}  // namespace
''', ['g_smem_set', 'g_grid_blocks']),
    ('a ready flag beside its fields, no atomic', '''
namespace {
struct DeviceState {
  bool ready;
  int cluster_max;
};
DeviceState g_state[64];
int device_state(int dev, DeviceState** out) {
  if (!g_state[dev].ready) g_state[dev].ready = true;
  *out = &g_state[dev];
  return 0;
}
}  // namespace
''', ['g_state']),
    ('a static local cache', '''
extern "C" int amtpu_torch_x(int dev) {
  static int blocks = 0;
  if (blocks == 0) blocks = dev + 1;
  return blocks;
}
''', ['static local blocks']),
    ('guarded by a plain variable', '''
int g_lock;
int g_blocks[8];  // guarded-by: g_lock
''', ['g_lock', 'g_blocks']),
    ('guarded by no variable of the file', '''
int g_blocks[8];  // guarded-by: g_mutex
''', ['g_blocks']),
    ('a struct and its variable in one declaration', '''
struct Cache { int blocks; } g_cache;
''', ['g_cache']),
]

_SAFE = '''
#include <atomic>
#include <mutex>
// "not a { brace" and 'x'
namespace {
constexpr int kMax = 64;
const int kAlso = 3;
static const char* const kName = "a; b { c";
__device__ int g_device_counter;
__constant__ int g_table[4];
struct State {
  int blocks;
};
template <class K>
__global__ void kernel(K k) {
  __shared__ int s[32];
  static_assert(sizeof(K) > 0, "k");
}
std::mutex g_mutex;
std::once_flag g_once[kMax];
std::atomic<bool> g_ready[kMax];
State g_state[kMax];  // guarded-by: g_mutex
int get(int dev) {
  static std::mutex local_mutex;
  static const int kLocal = 2;
  std::lock_guard<std::mutex> lock(local_mutex);
  return static_cast<int>(g_state[dev].blocks) + kLocal;
}
}  // namespace
extern "C" int entry(int x) { return get(x); }
'''


@pytest.mark.parametrize('label, src, names', _RACY,
                         ids=[r[0] for r in _RACY])
def test_scan_refuses_racy_state(tmp_path, label, src, names):
    path = tmp_path / 'racy.cu'
    path.write_text(src)
    bad = [n for n, _, _, p in host_state(str(path)) if p]
    assert bad == names, (label, host_state(str(path)))


def test_scan_passes_guarded_state(tmp_path):
    path = tmp_path / 'safe.cu'
    path.write_text(_SAFE)
    got = {n: p for n, _, p, problem in host_state(str(path))
           if not problem}
    assert got == {'g_mutex': 'std::mutex', 'g_once': 'std::once_flag',
                   'g_ready': 'std::atomic',
                   'g_state': 'guarded-by: g_mutex',
                   'static local local_mutex': 'std::mutex'}
    assert not [p for *_, p in host_state(str(path)) if p]


# -- the kernels' attributes ------------------------------------------------

_ATTRIBUTE_CALL = re.compile(r'\bcudaFuncSetAttribute\s*\(')
_IDENT = re.compile(r'[A-Za-z_]\w*')
#: names a constant expression may hold besides k-constants
_CONSTANT_WORDS = {'static_cast', 'sizeof', 'int', 'unsigned', 'size_t',
                   'int32_t', 'int64_t', 'uint32_t'}


def _call_args(code, start):
    """The top-level arguments of the call whose '(' is at code[start]."""
    args, depth, begin = [], 0, start + 1
    for i in range(start, len(code)):
        c = code[i]
        if c in '([{':
            depth += 1
        elif c in ')]}':
            depth -= 1
            if depth == 0:
                args.append(code[begin:i])
                return [' '.join(a.split()) for a in args]
        elif c == ',' and depth == 1:
            args.append(code[begin:i])
            begin = i + 1
    raise ValueError('unclosed call at %d' % start)


def _runtime_names(expr):
    """The names of an expression that are no constant: anything but a
    k-constant (kSmemMax), a type or cast word, or a function, template
    or scope (followed by '(', '<' or '::'), whose arguments and members
    are held to the same rule."""
    bad = []
    for m in _IDENT.finditer(expr):
        name, rest = m.group(), expr[m.end():].lstrip()
        if re.match(r'k[A-Z0-9]', name) or name in _CONSTANT_WORDS or \
                rest.startswith(('(', '<', '::')):
            continue
        bad.append(name)
    return bad


def attributes(path):
    """[(line, function, attribute, value, runtime names)] of every
    cudaFuncSetAttribute of a CUDA source."""
    with open(path) as f:
        code = _blank(f.read())
    found = []
    for m in _ATTRIBUTE_CALL.finditer(code):
        fn, attr, value = _call_args(code, m.end() - 1)
        found.append((code.count('\n', 0, m.start()) + 1, fn, attr, value,
                      _runtime_names(value)))
    return found


@pytest.mark.parametrize('name, n', [
    ('clock.cu', 1), ('dominance.cu', 2), ('dominance_block.cu', 1),
    ('dominance_indexes.cu', 2), ('lexsort.cu', 3), ('linearize.cu', 2),
    ('members.cu', 1), ('registers.cu', 0)])
def test_kernel_attributes_are_constant(name, n):
    """Every attribute a kernel source sets is a constant of the
    function, the same from every call: a shape's own shared memory set
    by one thread could lower the attribute under another thread's
    launch of a larger shape (the launch then fails)."""
    got = attributes(os.path.join(CSRC, name))
    assert len(got) == n, got
    assert not [a for a in got if a[4]], [a for a in got if a[4]]


@pytest.mark.parametrize('value, names', [
    ('static_cast<int>(smem)', ['smem']),
    ('static_cast<int>(pre_bytes)', ['pre_bytes']),
    ('static_cast<int>(one_cta_smem(L))', ['L']),
    ('words * 4 * kObjsPerBlock', ['words']),
    ('static_cast<int>(kSmemMax)', []),
    ('static_cast<int>(P::kBytes)', []),
    ('static_cast<int>(tile_bytes<kDigitBits>(kTileMax))', []),
    ('kShortMaxBytes * kObjsPerBlock', []),
    ('1', []),
])
def test_attribute_scan_names_runtime_values(tmp_path, value, names):
    path = tmp_path / 'attr.cu'
    path.write_text("""
int launch(int L, int words, size_t smem, size_t pre_bytes) {
  // cudaFuncSetAttribute(commented, out, smem)
  cudaError_t e = cudaFuncSetAttribute(
      kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      %s);
  return static_cast<int>(e);
}
""" % value)
    got = attributes(str(path))
    assert [(line, fn, attr) for line, fn, attr, _, _ in got] == [
        (4, 'kernel<K>', 'cudaFuncAttributeMaxDynamicSharedMemorySize')]
    assert got[0][4] == names

"""dispatch-alias checker: host buffers that a host->device seam may
still be reading when the caller touches them again.

On a CPU tensor `torch.from_numpy`, `torch.as_tensor` and
`torch.frombuffer` are zero-copy, and so is `ops/registers.py::upload`
(`torch.from_numpy(host).to(device)` returns the same storage when the
device is the CPU).  A numpy array handed to one of them therefore
backs the tensor: mutating it afterwards rewrites what a CPU pool's
kernels read, and on a card an asynchronous copy from page-locked
memory reads it after the call returned.  The safe idioms are a private
copy at the call (`np.array(x)` / `x.copy()` /
`np.ascontiguousarray(x)`), or never touching the buffer again.  The
pool's `_upload` and the engine's `_up` take that private copy before
they call `upload`.

This checker flags, per function scope:

  (a) a bare name passed to a seam (`torch.from_numpy/as_tensor/
      frombuffer`, `upload`) that is later MUTATED in the same scope:
      `x[...] = ...`, `x += ...`, `x.fill/sort/put/partition/resize(...)`,
      `np.copyto(x, ...)` or an `out=x` keyword (`post-seam-mutation`).
      A seam inside a loop also flags mutations of its captured names
      anywhere in the loop body, earlier lines included: iteration k+1's
      refill rewrites what iteration k handed over
      (`loop-staging-reuse`) -- unless the name is rebound inside the
      loop (a fresh buffer per iteration).  Rebinding (`x = ...`)
      releases the capture;
  (b) a view of a C++ column handed to a seam without a private copy:
      `np.ctypeslib.as_array(...)`, `_view(...)`, a slice of either, or a
      name bound to one of those earlier in the scope
      (`cxx-view-upload`).  The C++ buffers are freed with their batch,
      and a rollback rewrites them;
  (c) a host->device copy with `non_blocking=True` anywhere but `upload`
      (`async-upload`): `.to(..., non_blocking=True)`,
      `.cuda(non_blocking=True)`, `.copy_(src, non_blocking=True)`.  A
      device->host copy is the other direction and is not flagged: a
      `.to('cpu', ...)` / `.cpu(...)`, or a `.copy_` into a tensor this
      scope made on the host (`torch.empty(..., pin_memory=True)` or
      `device='cpu'`), such as the pool's pinned fetch.

`# static-ok: dispatch-alias` suppresses a reviewed line.  The runtime
sibling is `analysis.sanitize`, which poisons staging buffers after
they were consumed, so an alias the static scan cannot see fails the
byte comparisons.
"""

import ast

from .engine import Finding, register

CHECKER = 'dispatch-alias'

#: torch constructors that share the numpy buffer on a CPU tensor
ZERO_COPY = {'from_numpy', 'as_tensor', 'frombuffer'}
#: the port's one host->device seam (ops/registers.py), which hands
#: over the array it is given
UPLOAD_NAMES = {'upload'}
#: views of C++ memory
CXX_VIEWS = {'as_array', '_view'}
#: mutating method calls on a captured buffer
MUTATING_METHODS = {'fill', 'sort', 'put', 'partition', 'resize',
                    'setfield', 'itemset'}
#: host tensor constructors whose result is a device->host destination
HOST_ALLOCS = {'empty', 'zeros', 'empty_like', 'zeros_like', 'full'}


def _terminal_name(func):
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def _is_seam(node):
    """True when the Call `node` hands a host buffer to torch without a
    copy of its own."""
    name = _terminal_name(node.func)
    if name in ZERO_COPY:
        return isinstance(node.func, ast.Attribute) \
            and isinstance(node.func.value, ast.Name) \
            and node.func.value.id == 'torch'
    return name in UPLOAD_NAMES


def _is_cxx_view(expr):
    """A C++ column view, or a slice of one (False for None)."""
    while isinstance(expr, ast.Subscript):
        expr = expr.value
    return isinstance(expr, ast.Call) \
        and _terminal_name(expr.func) in CXX_VIEWS


def _scope_statements(fn):
    """Every statement in the function in source order (nested defs
    stay separate scopes and are walked on their own)."""
    stmts = []

    def walk(body):
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            stmts.append(stmt)
            for field in ('body', 'orelse', 'finalbody', 'handlers'):
                sub = getattr(stmt, field, None)
                if sub:
                    for h in sub:
                        if isinstance(h, ast.excepthandler):
                            walk(h.body)
                    if not isinstance(sub[0], ast.excepthandler):
                        walk(sub)
    walk(fn.body)
    return stmts


def _own_nodes(fn):
    """Every node of `fn`'s own scope (nested defs and lambdas
    excluded)."""
    out = []
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        out.append(node)
        stack.extend(ast.iter_child_nodes(node))
    return out


def _mutations_of(stmt, name):
    """Line numbers where `stmt` mutates the buffer bound to `name`."""
    hits = []
    for node in ast.walk(stmt):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Subscript) \
                        and isinstance(t.value, ast.Name) \
                        and t.value.id == name:
                    hits.append(node.lineno)
        elif isinstance(node, ast.AugAssign):
            t = node.target
            if isinstance(t, ast.Subscript):
                t = t.value
            if isinstance(t, ast.Name) and t.id == name:
                hits.append(node.lineno)
        elif isinstance(node, ast.Call):
            fname = _terminal_name(node.func)
            if fname in MUTATING_METHODS \
                    and isinstance(node.func, ast.Attribute) \
                    and isinstance(node.func.value, ast.Name) \
                    and node.func.value.id == name:
                hits.append(node.lineno)
            elif fname == 'copyto' and node.args \
                    and isinstance(node.args[0], ast.Name) \
                    and node.args[0].id == name:
                hits.append(node.lineno)
            for kw in node.keywords:
                if kw.arg == 'out' and isinstance(kw.value, ast.Name) \
                        and kw.value.id == name:
                    hits.append(node.lineno)
    return hits


def _rebinds(nodes, name):
    """True when `name` is (re)bound by a plain assignment among
    `nodes` -- a fresh object, not the captured buffer."""
    for node in nodes:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == name:
                    return True
    return False


def _loops(fn):
    """{loop_node: set(nodes lexically inside it)} for every for/while
    of `fn`'s own scope."""
    return {node: set(ast.walk(node)) for node in _own_nodes(fn)
            if isinstance(node, (ast.For, ast.While))}


def _bindings(fn):
    """[(line, name, value)] of the plain single-name assignments of
    `fn`'s own scope, in source order."""
    out = []
    for node in _own_nodes(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            out.append((node.lineno, node.targets[0].id, node.value))
    return sorted(out, key=lambda b: b[0])


def _bound_value(bindings, name, line):
    """The value of the last assignment to `name` before `line`."""
    value = None
    for ln, n, v in bindings:
        if ln >= line:
            break
        if n == name:
            value = v
    return value


def _kw(node, name):
    for kw in node.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _is_true(expr):
    return isinstance(expr, ast.Constant) and expr.value is True


def _is_cpu(expr):
    return isinstance(expr, ast.Constant) and expr.value == 'cpu'


def _host_destination(bindings, expr, line):
    """True when `expr` names a tensor this scope allocated on the host
    (pinned, or on device 'cpu') before `line`."""
    if not isinstance(expr, ast.Name):
        return False
    value = _bound_value(bindings, expr.id, line)
    return isinstance(value, ast.Call) \
        and _terminal_name(value.func) in HOST_ALLOCS \
        and (_is_true(_kw(value, 'pin_memory'))
             or _is_cpu(_kw(value, 'device')))


def _async_upload(node, bindings):
    """True when the Call `node` is a host->device copy with
    non_blocking=True."""
    if not _is_true(_kw(node, 'non_blocking')) \
            or not isinstance(node.func, ast.Attribute):
        return False
    name = node.func.attr
    if name == 'to':
        target = node.args[0] if node.args else _kw(node, 'device')
        return not _is_cpu(target)
    if name == 'cuda':
        return True
    if name == 'copy_':
        return not _host_destination(bindings, node.func.value,
                                     node.lineno)
    return False


def _check_function(src, fn, findings):
    calls = [n for n in _own_nodes(fn) if isinstance(n, ast.Call)]
    seams = [n for n in calls if n.args and _is_seam(n)]
    copies = [n for n in calls if _is_true(_kw(n, 'non_blocking'))]
    if not seams and not copies:
        return
    stmts = _scope_statements(fn)
    loops = _loops(fn)
    bindings = _bindings(fn)
    seen = set()

    def emit(code, line, message):
        key = (code, line, message)
        if key not in seen:
            seen.add(key)
            findings.append(Finding(CHECKER, code, src.path, line,
                                    message))

    for node in copies:
        if fn.name not in UPLOAD_NAMES and _async_upload(node, bindings):
            emit('async-upload', node.lineno,
                 'asynchronous host->device copy (non_blocking=True) '
                 'outside ops/registers.py::upload -- the host buffer may '
                 'still be read after this returns; go through upload')

    for node in sorted(seams, key=lambda n: (n.lineno, n.col_offset)):
        arg = base = node.args[0]
        while isinstance(base, ast.Subscript):
            base = base.value
        view = _is_cxx_view(base) or (
            isinstance(base, ast.Name)
            and _is_cxx_view(_bound_value(bindings, base.id,
                                          node.lineno)))
        if view:
            emit('cxx-view-upload', node.lineno,
                 '%s hands a view of C++ memory to a host->device '
                 'seam -- take a private copy (np.array(...)) first'
                 % ast.unparse(arg))
        if not isinstance(arg, ast.Name):
            continue
        name = arg.id
        for later in stmts:
            if later.lineno < node.lineno:
                continue
            for mline in _mutations_of(later, name):
                if mline > node.lineno:
                    emit('post-seam-mutation', mline,
                         '%r was handed to a host->device seam at '
                         'line %d and is mutated here -- the tensor '
                         'may share its memory; hand the seam '
                         'np.array(%s) or drop the mutation'
                         % (name, node.lineno, name))
            if later.lineno > node.lineno \
                    and _rebinds(ast.walk(later), name):
                break
        for loop, body in loops.items():
            if node not in body or _rebinds(body, name):
                continue
            for body_stmt in loop.body:
                for mline in _mutations_of(body_stmt, name):
                    if mline <= node.lineno:
                        emit('loop-staging-reuse', mline,
                             '%r is refilled here and handed to a '
                             'host->device seam at line %d in the '
                             'same loop -- iteration k+1\'s fill '
                             'rewrites what iteration k handed over; '
                             'allocate a fresh buffer per iteration '
                             'or hand the seam np.array(%s)'
                             % (name, node.lineno, name))


@register(CHECKER)
def check(sources, ctx):
    findings = []
    for src in sources:
        for node in ast.walk(src.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                _check_function(src, node, findings)
    return findings

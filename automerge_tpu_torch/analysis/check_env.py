"""env-latch checker: the port reads no ``AMTPU_*`` variable, and its
map of the JAX package's flags (`env_spec.PORT_KNOBS`) holds.

Four surfaces:

  1. **raw reads** -- an `os.environ[...]`, `os.environ.get(...)`,
     `os.getenv(...)` or `... in os.environ` of an ``AMTPU_`` key
     anywhere in the port (`direct-read`): its knobs are module
     constants;
  2. **the named constants** -- a row's `constant` must be a
     module-level assignment of the named module, found by an AST
     lookup (`missing-constant`), and where its value is a literal it
     must equal the row's (`default-drift`);
  3. **C++** -- every ``getenv("AMTPU_X")`` of `native/core.cpp`, which
     the port builds, needs a row marked `core` (`unmarked-getenv`), and
     a row marked `core` needs such a site (`consumer-drift`);
  4. **the latch ABI** -- the numeric latch defaults the port's own
     build of the library reports through `amtpu_latch_defaults` must
     equal the rows' (`abi-drift`).
"""

import ast
import ctypes
import operator
import os
import re

from .engine import Finding, register
from .env_spec import ABI_LATCH_DEFAULTS, KNOBS, PORT_KNOBS, expected_value

CHECKER = 'env-latch'

PACKAGE = 'automerge_tpu_torch'

_BINOPS = {ast.Add: operator.add, ast.Sub: operator.sub,
           ast.Mult: operator.mul, ast.LShift: operator.lshift,
           ast.Pow: operator.pow}


def _terminal_name(func):
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def _is_environ(node):
    """True for the expression `os.environ`."""
    return (isinstance(node, ast.Attribute) and node.attr == 'environ'
            and isinstance(node.value, ast.Name)
            and node.value.id == 'os')


def _amtpu_key(node):
    """The literal AMTPU_* key of an expression, else None."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str) \
            and node.value.startswith('AMTPU_'):
        return node.value
    return None


def _check_raw_reads(src, findings):
    for node in ast.walk(src.tree):
        key = None
        if isinstance(node, ast.Subscript) and _is_environ(node.value):
            key = _amtpu_key(node.slice)
        elif isinstance(node, ast.Compare) and len(node.ops) == 1 \
                and isinstance(node.ops[0], (ast.In, ast.NotIn)) \
                and _is_environ(node.comparators[0]):
            key = _amtpu_key(node.left)
        elif isinstance(node, ast.Call) and node.args:
            name = _terminal_name(node.func)
            if name == 'get' and isinstance(node.func, ast.Attribute) \
                    and _is_environ(node.func.value):
                key = _amtpu_key(node.args[0])
            elif name == 'getenv' and isinstance(node.func, ast.Attribute) \
                    and isinstance(node.func.value, ast.Name) \
                    and node.func.value.id == 'os':
                key = _amtpu_key(node.args[0])
        if key is not None:
            findings.append(Finding(
                CHECKER, 'direct-read', src.path, node.lineno,
                'environment read of %s -- the port reads no AMTPU_* '
                'variable: make it a module constant (env_spec.PORT_KNOBS '
                'names one per flag)' % key))


def _value_of(expr):
    """The value of a literal or a constant arithmetic expression
    (`1 << 17`), else raises ValueError."""
    if isinstance(expr, ast.BinOp) and type(expr.op) in _BINOPS:
        return _BINOPS[type(expr.op)](_value_of(expr.left),
                                      _value_of(expr.right))
    return ast.literal_eval(expr)


def _module_assignments(sources):
    """{dotted module under the package: {NAME: value node}} of the
    module-level assignments."""
    out = {}
    for src in sources:
        rel = src.relpath.replace(os.sep, '/')
        if not rel.startswith(PACKAGE + '/'):
            continue
        mod = rel[len(PACKAGE) + 1:-len('.py')].replace('/', '.')
        if mod.endswith('__init__'):
            mod = mod[:-len('__init__')].rstrip('.')
        names = out.setdefault(mod, {})
        for node in src.tree.body:
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets, value = [node.target], node.value
            else:
                continue
            for t in targets:
                if isinstance(t, ast.Name):
                    names[t.id] = (value, src.path, node.lineno)
    return out


def _check_constants(sources, ctx, findings):
    spec_path = os.path.join(ctx.root, PACKAGE, 'analysis', 'env_spec.py')
    modules = _module_assignments(sources)
    for knob in PORT_KNOBS:
        if knob.constant is None:
            continue
        mod, _, name = knob.constant.rpartition('.')
        found = modules.get(mod, {}).get(name)
        if found is None:
            findings.append(Finding(
                CHECKER, 'missing-constant', spec_path, 0,
                '%s names %s, but %s.%s has no module-level %s'
                % (knob.flag, knob.constant, PACKAGE, mod, name)))
            continue
        value_node, path, line = found
        try:
            value = _value_of(value_node)
        except ValueError:
            continue           # a computed value: nothing to compare
        want = expected_value(knob)
        if value != want or isinstance(value, bool) \
                != isinstance(want, bool):
            findings.append(Finding(
                CHECKER, 'default-drift', path, line,
                '%s = %r, but env_spec gives %r for %s'
                % (name, value, want, knob.flag)))


def _check_cpp(ctx, findings):
    cpp_path = os.path.join(ctx.root, 'native', 'core.cpp')
    try:
        with open(cpp_path, encoding='utf-8') as f:
            cpp = f.read()
    except OSError:
        findings.append(Finding(
            CHECKER, 'cpp-missing', cpp_path, 0,
            'native/core.cpp is missing'))
        return
    seen = set()
    for m in re.finditer(r'getenv\("(AMTPU_[A-Z0-9_]+)"\)', cpp):
        key = m.group(1)
        seen.add(key)
        knob = KNOBS.get(key)
        if knob is None or not knob.core:
            findings.append(Finding(
                CHECKER, 'unmarked-getenv', cpp_path,
                cpp.count('\n', 0, m.start()) + 1,
                'core.cpp reads %s, but no env_spec.PORT_KNOBS row marks '
                'it as read by the C++ core' % key))
    for knob in PORT_KNOBS:
        if knob.core and knob.flag not in seen:
            findings.append(Finding(
                CHECKER, 'consumer-drift', cpp_path, 1,
                'env_spec marks %s as read by the C++ core, but core.cpp '
                'never reads it' % knob.flag))


def _check_abi_defaults(ctx, findings):
    try:
        from ..native import _lib
        lib = _lib.lib()
    except (ImportError, OSError, RuntimeError) as e:
        findings.append(Finding(
            CHECKER, 'abi-unavailable', os.path.join(ctx.root, 'native',
                                                     'core.cpp'), 0,
            'the port\'s build of the C++ core is unavailable (%s); the '
            'latch-default check needs it' % e))
        return
    path = _lib.build()
    out = (ctypes.c_int64 * len(ABI_LATCH_DEFAULTS))()
    lib.amtpu_latch_defaults(out)
    for i, name in enumerate(ABI_LATCH_DEFAULTS):
        if int(out[i]) != KNOBS[name].default:
            findings.append(Finding(
                CHECKER, 'abi-drift', path, 0,
                'amtpu_latch_defaults reports %s=%d but env_spec gives %r'
                % (name, int(out[i]), KNOBS[name].default)))


@register(CHECKER)
def check(sources, ctx):
    findings = []
    for src in sources:
        _check_raw_reads(src, findings)
    _check_constants(sources, ctx, findings)
    _check_cpp(ctx, findings)
    _check_abi_defaults(ctx, findings)
    return findings

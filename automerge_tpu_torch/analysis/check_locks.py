"""lock-discipline checker: `# guarded-by:` annotations enforced.

Annotation grammar (trailing comment on the attribute's assignment,
conventionally in ``__init__``):

    self._items = []          # guarded-by: self._lock
    self._resp = {}           # guarded-by: self._resp_cond
    self.depth_ops = 0        # guarded-by: self._lock|self._work
    self._pools = None        # guarded-by(w): self._pools_lock

* ``lock|lock`` lists alternates that guard the same state (a
  `threading.Condition` built ON a lock is the canonical case).
* ``guarded-by(w)`` checks WRITES only -- the double-checked publish
  pattern (racy read, locked construct-and-assign) stays legal.

Enforcement: inside the annotating class, every load/store of an
annotated ``self.<attr>`` must sit lexically inside ``with <lock>:``
(any alternate), except:

  * the method that carries the annotation (``__init__``: the object
    is not shared yet);
  * methods whose ``def`` line carries ``# holds-lock: <lock>`` (the
    caller owns the lock -- documented at the def, checked at the
    sites);
  * lines carrying ``# static-ok: lock-discipline`` (reviewed benign
    races -- say why in the comment).

The checker is lexical and per class: cross-object access (another
object's attributes) and dynamic lock juggling are out of scope.  The
annotated state is the shared state of the serving and pool layers:
the gateway queue, the sidecar demux, the mesh chip pools, the
telemetry registry.
"""

import ast
import re

from .engine import Finding, register

CHECKER = 'lock-discipline'

_GUARD_RE = re.compile(r'guarded-by(\((?P<mode>w)\))?:\s*(?P<locks>[^#]+)')
_HOLDS_RE = re.compile(r'holds-lock:\s*(?P<locks>[^#]+)')


def _norm(expr):
    return expr.replace(' ', '').strip()


def _parse_locks(text):
    return tuple(_norm(p) for p in text.split('|') if p.strip())


def _self_attr_of_assign(stmt):
    """The attribute name when `stmt` assigns (only) to self.<attr>."""
    targets = []
    if isinstance(stmt, ast.Assign):
        targets = stmt.targets
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        targets = [stmt.target]
    for t in targets:
        if isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name) \
                and t.value.id == 'self':
            return t.attr
    return None


def _collect_annotations(src, cls):
    """{attr: (locks, writes_only, method_name)} from trailing
    guarded-by comments on self.<attr> assignments in `cls`."""
    out = {}
    for method in cls.body:
        if not isinstance(method, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
            continue
        for stmt in ast.walk(method):
            if not isinstance(stmt, (ast.Assign, ast.AugAssign,
                                     ast.AnnAssign)):
                continue
            attr = _self_attr_of_assign(stmt)
            if attr is None:
                continue
            for line in range(stmt.lineno,
                              (stmt.end_lineno or stmt.lineno) + 1):
                m = _GUARD_RE.search(src.comments.get(line, ''))
                if m:
                    out[attr] = (_parse_locks(m.group('locks')),
                                 m.group('mode') == 'w', method.name)
                    break
    return out


def _holds_locks(src, method):
    """Locks a method's def-line comment declares as already held."""
    for line in range(method.lineno, method.body[0].lineno + 1):
        m = _HOLDS_RE.search(src.comments.get(line, ''))
        if m:
            return _parse_locks(m.group('locks'))
    return ()


class _Visitor(ast.NodeVisitor):
    """Walks one method tracking the lexical `with` stack.

    Nested defs/lambdas are NOT descended into: a closure created under
    `with lock:` typically runs LATER on another thread (executor
    submit, callback), so treating it as lock-held would be wrong --
    and visiting it with an empty stack would flag helpers whose every
    caller holds the lock.  Deferred-closure discipline is out of this
    checker's lexical scope."""

    def visit_FunctionDef(self, node):
        pass

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef

    def __init__(self, src, method, annotations, held, findings):
        self.src = src
        self.method = method
        self.annotations = annotations
        self.held = list(held)
        self.findings = findings

    def visit_With(self, node):
        exprs = [_norm(ast.unparse(item.context_expr))
                 for item in node.items]
        self.held.extend(exprs)
        for stmt in node.body:
            self.visit(stmt)
        # also walk the context expressions themselves (unguarded)
        del self.held[len(self.held) - len(exprs):]
        for item in node.items:
            self.visit(item.context_expr)

    def visit_Attribute(self, node):
        if isinstance(node.value, ast.Name) and node.value.id == 'self' \
                and node.attr in self.annotations:
            locks, writes_only, _home = self.annotations[node.attr]
            is_store = isinstance(node.ctx, (ast.Store, ast.Del))
            if (is_store or not writes_only) \
                    and not any(lk in self.held for lk in locks):
                kind = 'store' if is_store else 'load'
                self.findings.append(Finding(
                    CHECKER, 'unguarded-access', self.src.path,
                    node.lineno,
                    'self.%s (%s) is guarded by %s but this %s is '
                    'outside any `with %s:` block'
                    % (node.attr, 'guarded-by(w)' if writes_only
                       else 'guarded-by', '|'.join(locks), kind,
                       locks[0])))
        self.generic_visit(node)


@register(CHECKER)
def check(sources, ctx):
    findings = []
    for src in sources:
        for cls in ast.walk(src.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            annotations = _collect_annotations(src, cls)
            if not annotations:
                continue
            for method in cls.body:
                if not isinstance(method, (ast.FunctionDef,
                                           ast.AsyncFunctionDef)):
                    continue
                # the annotating method (construction) is exempt for
                # exactly the attrs it annotates
                active = {a: spec for a, spec in annotations.items()
                          if spec[2] != method.name}
                if not active:
                    continue
                held = _holds_locks(src, method)
                v = _Visitor(src, method, active, held, findings)
                for stmt in method.body:
                    v.visit(stmt)
    return findings

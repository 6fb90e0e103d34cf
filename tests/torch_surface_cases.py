"""Runs the JAX package's pure-Python scenario tests against both
packages and records what each package's surface did, for the port's
parity tests (`tests/test_torch_{backend,frontend,api,connection}.py`).

`port_module(name)` builds the port's twin of a scenario module
`tests/<name>.py`: its source with every `automerge_tpu` import turned
into `automerge_tpu_torch`, executed as a module of its own.  The JAX
module itself is imported as it is; neither file is edited.

`scenarios(mod)` lists the module's tests (functions, and methods of
`Test*` classes, each `pytest.mark.parametrize` case expanded) as ids
that `run(mod, sid, pkg)` executes: module fixtures the test names are
called from the module, and a deterministic uuid factory is installed in
the package for the run.  While it runs, a `Recorder` logs every call
into the package's backend (change requests, changes, clocks in; patches
and changes out), the frontend's changes, undos, redos and patch
applications (the request and the materialized document) and every
message a sync `Connection` sends, as JSON.  `run` answers the test's
outcome and that log as one JSON string, so two packages agree on a
scenario when the strings are equal.
"""

import functools
import importlib
import inspect
import itertools
import json
import os
import re
import sys
import types

HERE = os.path.dirname(os.path.abspath(__file__))

_BACKEND_FNS = ('init', 'apply_changes', 'apply_local_change', 'get_patch',
                'get_changes', 'get_changes_for_actor',
                'get_missing_changes', 'get_missing_deps', 'merge')
_FRONTEND_FNS = ('init', 'change', 'empty_change', 'undo', 'redo',
                 'apply_patch')
_PORT_IMPORT = re.compile(r'\bautomerge_tpu\b(?!_torch)')


def jax_module(name):
    if HERE not in sys.path:
        sys.path.insert(0, HERE)
    return importlib.import_module(name)


_PORT_MODULES = {}


def port_module(name, overrides=None):
    """The port's twin of scenario module `name`; `overrides` maps a
    module-level name to the object the twin uses instead (a pool made
    on the CPU where the module makes one on the default device)."""
    key = (name, tuple(sorted(overrides or {})))
    if key in _PORT_MODULES:
        return _PORT_MODULES[key]
    path = os.path.join(HERE, name + '.py')
    with open(path) as f:
        src = _PORT_IMPORT.sub('automerge_tpu_torch', f.read())
    mod = types.ModuleType('port_' + name)
    mod.__file__ = path
    exec(compile(src, path, 'exec'), mod.__dict__)
    replaced = {}
    for attr, obj in (overrides or {}).items():
        replaced[id(getattr(mod, attr))] = obj
        setattr(mod, attr, obj)
    mod._am_replaced = replaced
    _PORT_MODULES[key] = mod
    return mod


def _params(fn):
    """The parametrize cases of a test: a list of (id, kwargs)."""
    cases = [('', {})]
    for mark in getattr(fn, 'pytestmark', ()):
        if mark.name != 'parametrize':
            continue
        names, values = mark.args[0], mark.args[1]
        if isinstance(names, str):
            names = [n.strip() for n in names.split(',')]
        ids = mark.kwargs.get('ids')
        new = []
        for i, v in enumerate(values):
            vals = v if len(names) > 1 else (v,)
            tag = ids[i] if ids else str(i)
            for cid, kw in cases:
                new.append(('%s[%s]' % (cid, tag) if cid else '[%s]' % tag,
                            dict(kw, **dict(zip(names, vals)))))
        cases = new
    return cases


def scenarios(mod):
    """Ids of the module's tests, parametrize cases expanded."""
    out = []
    for name, obj in vars(mod).items():
        if name.startswith('test_') and inspect.isfunction(obj):
            out += [name + cid for cid, _ in _params(obj)]
        elif name.startswith('Test') and inspect.isclass(obj):
            for mname, m in vars(obj).items():
                if mname.startswith('test_') and inspect.isfunction(m):
                    out += ['%s.%s%s' % (name, mname, cid)
                            for cid, _ in _params(m)]
    return out


def _fixture(mod, name):
    """The plain function behind a module's pytest fixture."""
    fx = getattr(mod, name)
    if hasattr(fx, '_get_wrapped_function'):
        return fx._get_wrapped_function()
    return getattr(fx, '__wrapped__', fx)


def _resolve(mod, sid):
    """(callable, kwargs) of scenario `sid` in `mod`."""
    base, _, cid = sid.partition('[')
    cid = '[' + cid if cid else ''
    if '.' in base:
        cls_name, meth = base.split('.')
        cls = getattr(mod, cls_name)
        fn = getattr(cls, meth)
        obj = cls()
        if hasattr(obj, 'setup_method'):
            obj.setup_method(fn)
        call = functools.partial(fn, obj)
    else:
        fn = call = getattr(mod, base)
    kwargs = dict(_params(fn))[cid]
    replaced = getattr(mod, '_am_replaced', {})
    kwargs = {k: replaced.get(id(v), v) for k, v in kwargs.items()}
    sig = inspect.signature(fn)
    for p in list(sig.parameters)[1 if '.' in base else 0:]:
        if p not in kwargs:
            kwargs[p] = _fixture(mod, p)()
    return call, kwargs


def _default(o):
    if hasattr(o, 'isoformat'):
        return o.isoformat()
    return type(o).__name__


def _json(x):
    return json.loads(json.dumps(x, default=_default))


def _arg(a):
    """A call argument as logged: frontend documents, callbacks, backend
    states and the backend object itself (an option) left out."""
    if _is_state(a) or hasattr(a, '_object_id') or callable(a):
        return None
    if isinstance(a, dict):
        return _json({k: v for k, v in a.items()
                      if k not in ('state', 'backend')})
    return _json(a)


def _is_state(x):
    return isinstance(x, dict) and 'opSet' in x


class Recorder:
    """Wraps the surface functions of package `pkg` (and any module-level
    alias of them in the scenario module) for the length of a run."""

    def __init__(self, pkg, scenario_mod):
        self.pkg = pkg
        self.mod = scenario_mod
        self.log = []
        self._undo = []

    def _wrap(self, owner, name, kind):
        orig = getattr(owner, name)
        log = self.log
        to_plain = importlib.import_module(
            self.pkg + '.frontend.inspect_util').to_plain

        def out_of(result):
            if kind == 'backend':
                if isinstance(result, tuple):
                    return _json(result[1])
                return None if _is_state(result) else _json(result)
            if kind == 'frontend':
                if isinstance(result, tuple):
                    return [_json(to_plain(result[0])), _json(result[1])]
                return _json(to_plain(result))
            return None

        @functools.wraps(orig)
        def wrapper(*args, **kw):
            if kind == 'send':
                log.append(['send', _json(args[1:]), _json(kw)])
                return orig(*args, **kw)
            rec = [kind + '.' + name] + [_arg(a) for a in args]
            try:
                result = orig(*args, **kw)
            except Exception as e:
                log.append(rec + ['raise', type(e).__name__, str(e)])
                raise
            log.append(rec + [out_of(result)])
            return result
        setattr(owner, name, wrapper)
        self._undo.append((owner, name, orig))
        for attr, val in list(vars(self.mod).items()):
            if val is orig:
                setattr(self.mod, attr, wrapper)
                self._undo.append((self.mod, attr, orig))

    def __enter__(self):
        backend = importlib.import_module(self.pkg + '.backend')
        frontend = importlib.import_module(self.pkg + '.frontend')
        connection = importlib.import_module(self.pkg + '.sync.connection')
        for name in _BACKEND_FNS:
            self._wrap(backend, name, 'backend')
        for name in _FRONTEND_FNS:
            self._wrap(frontend, name, 'frontend')
        self._wrap(connection.Connection, 'send_msg', 'send')
        return self

    def __exit__(self, *exc):
        for owner, name, orig in reversed(self._undo):
            setattr(owner, name, orig)
        self._undo.clear()


def fixed_uuids(pkg):
    mod = importlib.import_module(pkg + '.utils.uuid')
    counter = itertools.count(1)
    mod.set_factory(lambda: '%08x-1111-4000-8000-%012x' % (next(counter), 0))
    return mod


def run(mod, sid, pkg):
    """Runs scenario `sid` of `mod` against package `pkg`: its outcome
    and the recorded log, as one JSON string."""
    uuid_mod = fixed_uuids(pkg)
    try:
        with Recorder(pkg, mod) as rec:
            try:
                call, kwargs = _resolve(mod, sid)
                call(**kwargs)
                outcome = 'passed'
            except Exception as e:
                outcome = '%s: %s' % (type(e).__name__, e)
    finally:
        uuid_mod.reset()
    return outcome, json.dumps(rec.log)


def assert_parity(jax_mod, port_mod, sid):
    """The scenario passes in both packages with equal logs."""
    jax_out, jax_log = run(jax_mod, sid, 'automerge_tpu')
    port_out, port_log = run(port_mod, sid, 'automerge_tpu_torch')
    assert jax_out == 'passed', 'the JAX package: %s' % jax_out
    assert port_out == 'passed', 'the port: %s' % port_out
    assert port_log == jax_log
    return json.loads(jax_log)

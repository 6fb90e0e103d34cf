"""The checker engine of the port's static gate: parse once, check many.

A `Source` bundles everything a checker wants about one Python file --
the text, the AST, and the per-line comments (AST drops comments, so
they come from `tokenize`; the lock checker's ``# guarded-by:`` and the
suppression markers live there).  `run_checks` walks the scanned roots
once, builds the sources, and hands the same list to every registered
checker, so adding a checker never adds a parse pass.

Suppression: a finding is dropped when its source line, or the block of
comment-only lines right above it, carries ``# static-ok: <checker>``
(or a bare ``# static-ok``), optionally followed by `` -- <reason>``.
Suppressions are for reviewed, deliberate exceptions -- the marker is
greppable.
"""

import ast
import io
import os
import tokenize

#: package subtrees scanned by default: the port (tests, the JAX package
#: and the smoke script stay out)
DEFAULT_SCAN_DIRS = ('automerge_tpu_torch',)

SUPPRESS_MARK = 'static-ok'


class Finding(object):
    """One checker hit, formatted `path:line: [checker] code: message`."""

    __slots__ = ('checker', 'code', 'path', 'line', 'message')

    def __init__(self, checker, code, path, line, message):
        self.checker = checker
        self.code = code
        self.path = path
        self.line = line
        self.message = message

    def format(self, root=None):
        path = self.path
        if root and path.startswith(root.rstrip(os.sep) + os.sep):
            path = path[len(root.rstrip(os.sep)) + 1:]
        return '%s:%d: [%s] %s: %s' % (path, self.line, self.checker,
                                       self.code, self.message)

    def __repr__(self):
        return '<Finding %s>' % self.format()


class Source(object):
    """One parsed Python file shared by every checker."""

    __slots__ = ('path', 'relpath', 'text', 'lines', 'tree', 'comments')

    def __init__(self, path, relpath, text):
        self.path = path
        self.relpath = relpath
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=path)
        self.comments = self._extract_comments(text)

    @staticmethod
    def _extract_comments(text):
        """{line_number: comment text (without '#')} -- logical-line
        comments AND trailing comments both land on their physical
        line."""
        out = {}
        try:
            toks = tokenize.generate_tokens(io.StringIO(text).readline)
            for tok in toks:
                if tok.type == tokenize.COMMENT:
                    out[tok.start[0]] = tok.string.lstrip('#').strip()
        except tokenize.TokenError:
            pass
        return out

    def line_text(self, lineno):
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ''

    def suppressed(self, lineno, checker):
        """True when the line, or the block of comment-only lines right
        above it, carries ``# static-ok[: checker[,checker]] [-- reason]``
        naming `checker` (or no checker)."""
        lines = [lineno]
        ln = lineno - 1
        while ln >= 1 and self.line_text(ln).lstrip().startswith('#'):
            lines.append(ln)
            ln -= 1
        for ln in lines:
            c = self.comments.get(ln, '')
            if SUPPRESS_MARK not in c:
                continue
            tail = c.split(SUPPRESS_MARK, 1)[1].lstrip(': ')
            names = [n.strip() for n in tail.split('--', 1)[0].split(',')
                     if n.strip()]
            if not names or checker in names:
                return True
        return False


#: name -> callable(sources, ctx) -> iterable[Finding]
CHECKERS = {}


def register(name):
    def deco(fn):
        CHECKERS[name] = fn
        return fn
    return deco


def iter_py_files(root, scan_dirs=DEFAULT_SCAN_DIRS):
    for sub in scan_dirs:
        base = os.path.join(root, sub)
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = [d for d in sorted(dirnames)
                           if d != '__pycache__']
            for fn in sorted(filenames):
                if fn.endswith('.py'):
                    yield os.path.join(dirpath, fn)


def load_sources(root, scan_dirs=DEFAULT_SCAN_DIRS, extra_files=()):
    """(sources, parse_findings): a file that does not parse becomes a
    `syntax-error` finding instead of aborting the whole gate -- every
    other file's checkers still run and report."""
    sources, broken = [], []
    for path in list(iter_py_files(root, scan_dirs)) + list(extra_files):
        with open(path, encoding='utf-8') as f:
            text = f.read()
        try:
            sources.append(Source(path, os.path.relpath(path, root),
                                  text))
        except SyntaxError as e:
            broken.append(Finding('engine', 'syntax-error', path,
                                  e.lineno or 0, str(e)))
    return sources, broken


class Context(object):
    """Cross-file context the checkers share: the repo root plus lazily
    loaded artifacts (the text of docs and the port's glossary)."""

    def __init__(self, root):
        self.root = root
        self._docs = {}

    def doc_text(self, relpath):
        """Text of a file under the root (cached; '' when absent)."""
        if relpath not in self._docs:
            path = os.path.join(self.root, relpath)
            try:
                with open(path, encoding='utf-8') as f:
                    self._docs[relpath] = f.read()
            except OSError:
                self._docs[relpath] = ''
        return self._docs[relpath]


def check_sources(root, sources, checkers=None):
    """Runs the selected checkers (default: all registered) over parsed
    `sources`; returns the suppression-filtered findings sorted by
    (path, line)."""
    # import for side effect: checker registration
    from . import (  # noqa: F401
        check_alias, check_env, check_locks, check_telemetry)
    unknown = sorted(set(checkers or ()) - set(CHECKERS))
    if unknown:
        raise ValueError('unknown checker(s) %s; known: %s'
                         % (', '.join(unknown),
                            ', '.join(sorted(CHECKERS))))
    by_path = {s.path: s for s in sources}
    ctx = Context(root)
    findings = []
    for name in (checkers or sorted(CHECKERS)):
        for f in CHECKERS[name](sources, ctx):
            src = by_path.get(f.path)
            if src is not None and src.suppressed(f.line, f.checker):
                continue
            findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.code))
    return findings


def run_checks(root, checkers=None, scan_dirs=DEFAULT_SCAN_DIRS,
               extra_files=()):
    """Parses the scan roots (and `extra_files`) once and runs the
    selected checkers over them; a file that does not parse is a
    `syntax-error` finding."""
    sources, broken = load_sources(root, scan_dirs, extra_files)
    findings = broken + check_sources(root, sources, checkers)
    findings.sort(key=lambda f: (f.path, f.line, f.code))
    return findings

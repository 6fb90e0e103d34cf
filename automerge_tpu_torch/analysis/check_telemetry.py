"""telemetry-key checker: the port's counters, their seeds and their docs
in lockstep.

Collects every statically reachable telemetry emit in the port:

  * flat always-on counters -- `trace.metric` / `telemetry.metric` call
    sites (string literals, and module-level string constants of the
    same file such as a kernel's `LAUNCH_METRIC`; `%`/f-string/`+`
    formats become wildcard patterns, so `'fallback.escalated.w%d' % W`
    still counts);
  * phase counters and spans -- `trace.count` / `phase_count` /
    `trace.span` names (they keep a doc row alive but are not
    pre-seeded); flight-recorder event stamps (`recorder.record`) count
    the same way;
  * registry families -- `registry.counter/gauge/histogram('amtpu_*')`.

Then enforces the JAX package's three invariants over them:

  1. every literal flat key whose prefix owns a ``KNOWN_*`` block of the
     port's `telemetry/__init__.py` is pre-seeded there -- a gate
     reading healthz or a bench block sees an explicit zero, not a
     missing key.  Formatted keys must match a `DYNAMIC_KEY_PATTERNS`
     family;
  2. every flat key and registry family is documented: a row of
     docs/OBSERVABILITY.md or docs/RESILIENCE.md (which describe the JAX
     package, whose key set the port keeps) or of the port's own
     glossary (`GLOSSARY`, its "Port-only keys" table);
  3. a seeded key with no emit site is a dead seed, reported at its own
     element of the `KNOWN_*` tuple (so one reviewed
     ``# static-ok: telemetry-key`` there covers one key), and a
     glossary row with no emit site is dead.

The two docs/ files are the JAX package's and are not the port's to
edit, so a key they document that the port does not emit is not a dead
row: it needs a reasoned row in the glossary's "Exemptions" table
(`unported-doc-row` otherwise), and an exemption for a key the port
does emit, or for a key no doc documents and no block seeds, is stale.
"""

import ast
import os
import re

from .engine import Finding, register

CHECKER = 'telemetry-key'

#: the port's own glossary, relative to the repo root
GLOSSARY = os.path.join('automerge_tpu_torch', 'analysis', 'glossary.md')
#: the JAX package's glossaries (read-only here)
JAX_DOCS = ('docs/OBSERVABILITY.md', 'docs/RESILIENCE.md')

#: flat-counter prefix -> the telemetry/__init__.py KNOWN tuple that
#: pre-seeds it into every bench_block / healthz payload.  Prefixes may
#: span multiple dot segments (`sync.fanout`); the LONGEST matching
#: prefix owns a key, and the seeded suffix is what follows it.
PRESEED_BLOCKS = {
    'fallback': 'KNOWN_FALLBACK_REASONS',
    'collect': 'KNOWN_COLLECT_KEYS',
    'resident': 'KNOWN_RESIDENT_BATCH_KEYS',
    'pipeline': 'KNOWN_PIPELINE_KEYS',
    'mesh': 'KNOWN_MESH_KEYS',
    'resilience': 'KNOWN_RESILIENCE_KEYS',
    'scheduler': 'KNOWN_SCHEDULER_KEYS',
    'sync.fanout': 'KNOWN_FANOUT_KEYS',
    'egress': 'KNOWN_EGRESS_KEYS',
    'storage': 'KNOWN_STORAGE_KEYS',
    'recorder': 'KNOWN_RECORDER_KEYS',
    'slo': 'KNOWN_SLO_KEYS',
    'capacity': 'KNOWN_CAPACITY_KEYS',
    'trace': 'KNOWN_TRACE_KEYS',
    'fleet': 'KNOWN_FLEET_KEYS',
    'router': 'KNOWN_ROUTER_KEYS',
    'migrate': 'KNOWN_MIGRATE_KEYS',
    'failover': 'KNOWN_FAILOVER_KEYS',
    'readview': 'KNOWN_READVIEW_KEYS',
}


def _preseed_ns_of(key):
    """The longest PRESEED_BLOCKS prefix owning `key`, or None."""
    best = None
    for ns in PRESEED_BLOCKS:
        if key.startswith(ns + '.') and (best is None
                                         or len(ns) > len(best)):
            best = ns
    return best


#: dynamic key families that are deliberately NOT pre-seeded row by row
#: (`*` matches within and across dots); everything else formatted at
#: runtime must land on a pre-seeded literal
DYNAMIC_KEY_PATTERNS = (
    'fallback.escalated.w*',        # tier ladder: one key per width
    'resilience.fault_injected.*',  # per-site subkeys (base is seeded)
)

#: counter namespaces whose docs/ rows are read as keys (first dot
#: segment of each preseed prefix, plus the un-seeded ones)
DOC_NAMESPACES = tuple(sorted({ns.split('.')[0]
                               for ns in PRESEED_BLOCKS})) + (
    'sched', 'sidecar', 'device', 'host', 'hostfull', 'hostreg',
    'sanitize', 'pallas', 'ops')

#: flat keys that feed derived exposition families instead of a
#: glossary row of their own (documented as amtpu_device_*_total)
UNDOCUMENTED_OK = {'device.dispatch_sync_s', 'device.dispatches'}

_TOKEN_RE = re.compile(r'`([A-Za-z0-9_./*%\[\]]+)`')
_KEY_RE = re.compile(r'^[a-z][a-z0-9_]*(\.[a-zA-Z0-9_.*]+)+$')
_BARE_RE = re.compile(r'^\.?[a-z][a-zA-Z0-9_]*$')


def _pattern_of(node, consts=None):
    """(literal, regex) for a key expression: literal keys (and names of
    module-level string constants in `consts`) return (key, None);
    formatted keys return (None, compiled_regex); opaque expressions
    return (None, None)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value, None
    if isinstance(node, ast.Name) and consts and node.id in consts:
        return consts[node.id], None
    lit = None
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mod) \
            and isinstance(node.left, ast.Constant) \
            and isinstance(node.left.value, str):
        lit = re.sub(r'%[-#0-9.]*[sdifrxX]', '*', node.left.value)
    elif isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add) \
            and isinstance(node.left, ast.Constant) \
            and isinstance(node.left.value, str):
        lit = node.left.value + '*'
    elif isinstance(node, ast.JoinedStr):
        parts = []
        for v in node.values:
            if isinstance(v, ast.Constant):
                parts.append(str(v.value))
            else:
                parts.append('*')
        lit = ''.join(parts)
    if lit is None:
        return None, None
    return None, _glob_re(lit)


def _glob_re(glob):
    return re.compile('^' + '.*'.join(re.escape(p)
                                      for p in glob.split('*')) + '$')


def _terminal_name(func):
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def _module_str_constants(tree):
    """{NAME: str} for module-level string constants (`LAUNCH_METRIC =
    'launch.registers'`)."""
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and isinstance(node.value, ast.Constant) \
                and isinstance(node.value.value, str):
            out[node.targets[0].id] = node.value.value
    return out


def _collect_emits(sources):
    """(flat_literals, flat_patterns, phase_names, families) --
    flat_literals: {key: (path, line)}; flat_patterns: [(regex, path,
    line)]; phase_names: set of span/count names; families: {name:
    (path, line)}."""
    flats, patterns, phases, families = {}, [], set(), {}
    pkg_self = os.path.join('automerge_tpu_torch', 'analysis') + os.sep
    for src in sources:
        if src.relpath.startswith(pkg_self) \
                and os.path.basename(src.path) != 'sanitize.py':
            # the checker modules quote key literals in messages and
            # pattern tables; sanitize.py is product runtime whose
            # emits count like any other
            continue
        consts = _module_str_constants(src.tree)
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            name = _terminal_name(node.func)
            if name == 'metric':
                lit, pat = _pattern_of(node.args[0], consts)
                if lit is not None:
                    flats.setdefault(lit, (src.path, node.lineno))
                elif pat is not None:
                    patterns.append((pat, src.path, node.lineno))
            elif name in ('count', 'phase_count', 'span', 'phase_add',
                          'span_with_context', 'fire', 'arm', 'record'):
                lit, pat = _pattern_of(node.args[0])
                if lit is not None:
                    phases.add(lit)
                elif pat is not None:
                    patterns.append((pat, src.path, node.lineno))
            elif name in ('counter', 'gauge', 'histogram'):
                lit, _ = _pattern_of(node.args[0])
                if lit is not None and lit.startswith('amtpu_'):
                    families.setdefault(lit, (src.path, node.lineno))
    return flats, patterns, phases, families


def _parse_known_blocks(sources):
    """{tuple_name: ({key: line}, path)} from the port's
    telemetry/__init__.py; each key carries the line of its own tuple
    element."""
    out = {}
    want = os.path.join('automerge_tpu_torch', 'telemetry', '__init__.py')
    for src in sources:
        if src.relpath != want:
            continue
        for node in src.tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and node.targets[0].id.startswith('KNOWN_') \
                    and isinstance(node.value, (ast.Tuple, ast.List)):
                keys = {e.value: e.lineno for e in node.value.elts
                        if isinstance(e, ast.Constant)}
                out[node.targets[0].id] = (keys, src.path)
    return out


def _doc_tokens(ctx):
    """Documented counter keys of the JAX package's two glossaries, with
    slash continuation: in `` `collect.conflict_sparse` /
    `conflict_dense` `` the continuation inherits the previous token's
    namespace -- but ONLY when separated by a bare slash, so prose
    backticks never fabricate keys.  A trailing ``[...]`` qualifier is
    stripped (`resilience.fault_injected[.site]`); tokens containing
    ``*`` are doc-side wildcard families."""
    tokens = {}
    gap_re = re.compile(r'^\s*/\s*$')
    for rel in JAX_DOCS:
        text = ctx.doc_text(rel)
        for ln, line in enumerate(text.splitlines(), 1):
            prefix, last_end = None, -1
            for m in _TOKEN_RE.finditer(line):
                tok = m.group(1).split('[')[0].rstrip('.')
                continues = prefix is not None and gap_re.match(
                    line[last_end:m.start()])
                if _KEY_RE.match(tok) and tok.split('.')[0] \
                        in DOC_NAMESPACES and not re.search(r'[A-Z]{2}',
                                                            tok):
                    tokens.setdefault(tok, (rel, ln))
                    prefix, last_end = tok.rsplit('.', 1)[0], m.end()
                elif continues and _BARE_RE.match(tok) \
                        and not tok.startswith('amtpu'):
                    full = prefix + tok if tok.startswith('.') \
                        else '%s.%s' % (prefix, tok)
                    tokens.setdefault(full, (rel, ln))
                    last_end = m.end()
                else:
                    prefix = None
    return tokens


def _glossary(ctx):
    """({key: line} of the "Port-only keys" table, {key: line} of the
    "Exemptions" table): the first backticked token of each table row
    under its `## ` heading."""
    tables = {'port-only keys': {}, 'exemptions': {}}
    section = None
    for ln, line in enumerate(ctx.doc_text(GLOSSARY).splitlines(), 1):
        if line.startswith('## '):
            section = tables.get(line[3:].strip().lower())
            continue
        if section is None or not line.startswith('|'):
            continue
        m = _TOKEN_RE.search(line)
        if m:
            section.setdefault(m.group(1), ln)
    return tables['port-only keys'], tables['exemptions']


def _canonical(key):
    """Digit runs collapse to N so `fallback.escalated.w16` matches the
    documented `fallback.escalated.wN`."""
    return re.sub(r'\d+', 'N', key)


def _emit_index(flats, patterns, phases):
    """emitted(key) -> bool over the collected emits: a literal, its
    digit-collapsed form, or a formatted pattern."""
    names = set(flats) | phases
    canon = {_canonical(k) for k in names}

    def emitted(key):
        return key in names or _canonical(key) in canon or any(
            pat.match(_canonical(key)) or pat.match(key)
            for pat, _p, _l in patterns)
    return emitted


@register(CHECKER)
def check(sources, ctx):
    findings = []
    flats, patterns, phases, families = _collect_emits(sources)
    emitted = _emit_index(flats, patterns, phases)
    known = _parse_known_blocks(sources)
    docs = _doc_tokens(ctx)
    port_rows, exempt = _glossary(ctx)
    glossary_path = os.path.join(ctx.root, GLOSSARY)
    doc_keys = {k for k in docs if '*' not in k} | set(port_rows)
    doc_globs = {k: _glob_re(k) for k in docs if '*' in k}
    # a whole-namespace glob (`resident.*`) keeps its row alive but is
    # too broad to DOCUMENT a key -- membership needs two literal
    # segments (`sidecar.client.*`)
    doc_globs_member = {k: g for k, g in doc_globs.items()
                        if k.split('*')[0].count('.') >= 2}
    doc_canon = {_canonical(k) for k in doc_keys}
    dynamic_res = [_glob_re(p) for p in DYNAMIC_KEY_PATTERNS]

    # 1. every literal flat emit with a pre-seeded prefix is in KNOWN
    for key, (path, line) in sorted(flats.items()):
        ns = _preseed_ns_of(key)
        block = PRESEED_BLOCKS.get(ns) if ns else None
        if block is not None:
            suffix = key[len(ns) + 1:]
            keys, _bp = known.get(block, ({}, None))
            if suffix not in keys \
                    and not any(r.match(key) for r in dynamic_res):
                findings.append(Finding(
                    CHECKER, 'unseeded-key', path, line,
                    '%s is emitted but not pre-seeded in telemetry.%s '
                    '-- gates would see a missing key instead of an '
                    'explicit zero' % (key, block)))
        # 2. documented somewhere
        if key not in doc_keys and _canonical(key) not in doc_canon \
                and not any(g.match(key)
                            for g in doc_globs_member.values()) \
                and key not in UNDOCUMENTED_OK:
            findings.append(Finding(
                CHECKER, 'undocumented-key', path, line,
                '%s has no row in docs/OBSERVABILITY.md, '
                'docs/RESILIENCE.md or %s' % (key, GLOSSARY)))

    # formatted emits with a pre-seeded namespace must match a declared
    # dynamic family (otherwise the runtime key can never be seeded)
    for pat, path, line in patterns:
        glob = pat.pattern
        ns_m = re.match(r'\^([a-z_]+)\\\.', glob)
        if ns_m and ns_m.group(1) in PRESEED_BLOCKS:
            sample = glob[1:-1].replace('\\', '').replace('.*', 'X')
            if not any(r.match(sample) for r in dynamic_res):
                findings.append(Finding(
                    CHECKER, 'undeclared-dynamic-key', path, line,
                    'formatted %s.* key does not match any '
                    'DYNAMIC_KEY_PATTERNS family' % ns_m.group(1)))

    # 3a. pre-seeded keys with no emit site are dead
    seeded = set()
    for ns, block in sorted(PRESEED_BLOCKS.items()):
        keys, bpath = known.get(block, ({}, None))
        for suffix, eline in sorted(keys.items()):
            key = '%s.%s' % (ns, suffix)
            seeded.add(key)
            if not emitted(key):
                findings.append(Finding(
                    CHECKER, 'dead-seed', bpath or '<telemetry>', eline,
                    '%s is pre-seeded in %s but nothing emits it'
                    % (key, block)))

    # 3b. glossary rows with no emit site are dead
    for tok, ln in sorted(port_rows.items()):
        if not emitted(tok) \
                and tok not in families:
            findings.append(Finding(
                CHECKER, 'dead-doc-row', glossary_path, ln,
                '`%s` is in the glossary but nothing emits it' % tok))

    # 3c. a JAX-package doc key the port does not emit needs a reasoned
    # exemption; an exemption of an emitted (or unknown) key is stale
    for tok, (rel, ln) in sorted(docs.items()):
        if '*' in tok:
            glob = doc_globs[tok]
            live = any(glob.match(k) for k in flats) \
                or any(glob.match(k) for k in phases)
        else:
            live = emitted(tok)
        if not live and tok not in exempt:
            findings.append(Finding(
                CHECKER, 'unported-doc-row', os.path.join(ctx.root, rel),
                ln, '`%s` is documented for the JAX package but the port '
                'emits nothing for it -- emit it, or exempt it with a '
                'reason in %s' % (tok, GLOSSARY)))
    for tok, ln in sorted(exempt.items()):
        if emitted(tok):
            findings.append(Finding(
                CHECKER, 'stale-exemption', glossary_path, ln,
                '`%s` is exempted but the port emits it' % tok))
        elif tok not in docs and tok not in seeded:
            findings.append(Finding(
                CHECKER, 'stale-exemption', glossary_path, ln,
                '`%s` is exempted but no doc documents it and no block '
                'seeds it' % tok))

    # registry families must be documented
    text = ''.join(ctx.doc_text(rel) for rel in JAX_DOCS + (GLOSSARY,))
    for fam, (path, line) in sorted(families.items()):
        if fam not in text:
            findings.append(Finding(
                CHECKER, 'undocumented-family', path, line,
                'registry family %s has no docs/OBSERVABILITY.md or '
                'glossary row' % fam))
    return findings

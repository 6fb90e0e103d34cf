"""The benchmark's one traffic generator.

Every input the benchmark sends is drawn here from `--seed`, from the
parameters of a configuration file (`configs/<name>.json`, the shape of
the documents) and of a traffic file (`traffic/<name>.json`, how the
calls arrive).  The same seed gives the same changes, byte for byte.
Each document draws from a `random.Random` of its own, seeded with a
string of the run's seed and the document's place, so that the plain
reference can rebuild any one document's history in another process
without the others.

Two document shapes, named by a configuration's `history`:

* `concurrent_text`: one Text object edited by many actors at once,
  `rounds` rounds of one change per actor, each change `ops_per_change`
  ops: an insert after the actor's previous character and either its
  character or, with probability `delete_share`, the delete of the
  actor's previous character (a frozen copy of the port's
  `workloads.text_doc_changes` and `build_config_3`).
* `long_text`: one Text object typed by one author (`Typist`), one
  change per keystroke: an insert after the cursor or a backspace, with
  the cursor moved to a random place every `cursor_jump_every`
  keystrokes.  The starting history has the configuration's `inserts`
  and `deletes` keystrokes, so its text keeps every deleted element in
  the list as Automerge does; the window's keystrokes then delete with
  probability `delete_share`.
"""

import random

import msgpack

ROOT_ID = '00000000-0000-0000-0000-000000000000'
#: the Text object of a long_text document
TEXT_OBJ = 't'
_LETTERS = 'abcdefghijklmnopqrstuvwxyz     '


def doc_rng(seed, *where):
    """The generator of one document's draws: a string seed, hashed by
    `random` with SHA-512, the same in every process and interpreter."""
    return random.Random('/'.join(str(x) for x in (seed,) + where))


def doc_id(d):
    return 'doc-%05d' % d


def op_count(changes_by_doc):
    return sum(len(c['ops']) for chs in changes_by_doc.values() for c in chs)


# ---------------------------------------------------------------------------
# concurrent_text
# ---------------------------------------------------------------------------

def concurrent_text_history(tid, n_actors, n_rounds, ops_per_change,
                            should_delete):
    """One doc's concurrent interleaved Text edit history (wire-format
    changes, causally ordered).  `should_delete(i, actor_n, has_last)`
    decides per slot whether to delete the actor's previous element
    instead of setting the new one."""
    changes = [{'actor': 'a0', 'seq': 1, 'deps': {}, 'ops': [
        {'action': 'makeText', 'obj': tid},
        {'action': 'ins', 'obj': tid, 'key': '_head', 'elem': 1},
        {'action': 'set', 'obj': tid, 'key': 'a0:1', 'value': 'x'},
        {'action': 'link', 'obj': ROOT_ID, 'key': 'text', 'value': tid}]}]
    max_elem = 1
    last = {}
    for r in range(1, n_rounds + 1):
        for a in range(n_actors):
            actor = 'a%d' % a
            seq = r + 1 if a == 0 else r
            ops = []
            for i in range(ops_per_change // 2):
                max_elem += 1
                prev = last.get(a) or 'a0:1'
                ops.append({'action': 'ins', 'obj': tid, 'key': prev,
                            'elem': max_elem})
                if should_delete(i, a, a in last):
                    ops.append({'action': 'del', 'obj': tid,
                                'key': last[a]})
                else:
                    ops.append({'action': 'set', 'obj': tid,
                                'key': '%s:%d' % (actor, max_elem),
                                'value': chr(97 + max_elem % 26)})
                last[a] = '%s:%d' % (actor, max_elem)
            changes.append({'actor': actor, 'seq': seq,
                            'deps': {'a0': 1}, 'ops': ops})
    return changes


def backlog_doc(config, seed, payload, d):
    """Doc `d` of backlog payload `payload`: its whole history."""
    rng = doc_rng(seed, 'backlog', payload, d)
    share = config['delete_share']
    return concurrent_text_history(
        'text-%d' % d, config['actors'], config['rounds'],
        config['ops_per_change'],
        lambda i, a, has: rng.random() < share and has)


def backlog_payload(config, seed, payload):
    """{doc id: [change, ...]} of every doc of backlog payload
    `payload`."""
    return {doc_id(d): backlog_doc(config, seed, payload, d)
            for d in range(config['docs_per_batch'])}


# ---------------------------------------------------------------------------
# long_text
# ---------------------------------------------------------------------------

class Typist:
    """The one author of doc `d`, typing into its Text object: one change
    per keystroke, an insert at the cursor or a backspace, with the
    cursor moved to a random place every `cursor_jump_every` keystrokes.

    `history()` types the document's starting history from an empty
    text, with exactly the configuration's `inserts` and `deletes`
    keystrokes in a random order; the text then holds `inserts` list
    elements, `inserts - deletes` of them visible.  `next_change()` then
    types on, each keystroke a delete with probability `delete_share`.

    The visible characters are kept in order, since a new character,
    whose counter is the largest yet, sits right after the one it is
    inserted after (the RGA rule).  Between two jumps the typing is kept
    apart from the rest of the text (`_run`, with the characters deleted
    on either side of where the run started) and spliced in at the next
    jump, so a keystroke costs no pass over the text."""

    def __init__(self, config, seed, d, actor='a0'):
        self.config, self.seed, self.d = config, seed, d
        self.actor = actor
        self.jump_every = config['cursor_jump_every']
        self.visible = []       # visible keys at the run's start
        self._at = 0            # the run's start in `visible`
        self._left = self._right = 0    # deleted around `_at`
        self._run = []          # keys typed in this run, still visible
        self.elem = 0
        self.seq = 1
        self.keys = 0
        self.rng = doc_rng(seed, 'keys', d)

    def __len__(self):
        return (len(self.visible) - self._left - self._right
                + len(self._run))

    def _move(self, rng):
        if self.keys % self.jump_every == 0:
            self.visible[self._at - self._left:self._at + self._right] = \
                self._run
            self._at = rng.randint(0, len(self.visible))
            self._left = self._right = 0
            self._run = []
        self.keys += 1
        self.seq += 1

    def _key(self, delete, rng):
        """One keystroke's change at the cursor (`delete`: a backspace,
        or a forward delete where nothing is left of the cursor)."""
        if delete:
            if self._run:
                key = self._run.pop()
            elif self._at > self._left:
                self._left += 1
                key = self.visible[self._at - self._left]
            else:
                key = self.visible[self._at + self._right]
                self._right += 1
            ops = [{'action': 'del', 'obj': TEXT_OBJ, 'key': key}]
        else:
            if self._run:
                after = self._run[-1]
            elif self._at > self._left:
                after = self.visible[self._at - self._left - 1]
            else:
                after = '_head'
            self.elem += 1
            new = '%s:%d' % (self.actor, self.elem)
            ops = [{'action': 'ins', 'obj': TEXT_OBJ, 'key': after,
                    'elem': self.elem},
                   {'action': 'set', 'obj': TEXT_OBJ, 'key': new,
                    'value': rng.choice(_LETTERS)}]
            self._run.append(new)
        return {'actor': self.actor, 'seq': self.seq, 'deps': {},
                'ops': ops}

    def history(self):
        """Yields the starting history: the change that makes and links
        the object, then `inserts` + `deletes` keystroke changes."""
        yield {'actor': self.actor, 'seq': 1, 'deps': {}, 'ops': [
            {'action': 'makeText', 'obj': TEXT_OBJ},
            {'action': 'link', 'obj': ROOT_ID, 'key': 'text',
             'value': TEXT_OBJ}]}
        rng = doc_rng(self.seed, 'text', self.d)
        ins, dels = self.config['inserts'], self.config['deletes']
        while ins + dels:
            self._move(rng)
            delete = len(self) > 0 and rng.random() * (ins + dels) < dels
            if delete:
                dels -= 1
            else:
                ins -= 1
            yield self._key(delete, rng)

    def next_change(self):
        self._move(self.rng)
        return self._key(len(self) > 0 and
                         self.rng.random() < self.config['delete_share'],
                         self.rng)


def history_length(config):
    """Changes in a long_text document's starting history."""
    return 1 + config['inserts'] + config['deletes']


def long_text_build(config, seed, docs):
    """The build batch of docs `docs`, packed as the wire's msgpack
    change by change, and each doc's Typist where its history ends."""
    packer = msgpack.Packer(use_bin_type=True)
    typists = [Typist(config, seed, d) for d in docs]
    parts = [packer.pack_map_header(len(typists))]
    for d, t in zip(docs, typists):
        parts.append(packer.pack(doc_id(d)))
        parts.append(packer.pack_array_header(history_length(config)))
        parts.extend(packer.pack(c) for c in t.history())
    return b''.join(parts), typists


def keystrokes(config, seed, d, n):
    """The first `n` keystroke changes of doc `d` after its history."""
    t = Typist(config, seed, d)
    for _ in t.history():
        pass
    return [t.next_change() for _ in range(n)]

"""The `backend=tpu` seam on the port: port frontends with
`adapter/backend-tpu.js`'s Backend surface as their immediate backend,
request for request (`torch_frontend_cases.PortMirror`), against a port
sidecar server subprocess on the CPU (`python -m
automerge_tpu_torch.sidecar.server --device cpu`, the adapter worker's
JSON-lines framing on stdio).

Each lane of `chip_smoke.py` phase 15 runs here at a small size: the
reference-shaped session (a), config 1 typed through two frontends (b,
500 characters) and concurrent assignments (c, 10 writers on one hot
key).  Every transcript (each request, patch and materialized document)
must equal, as JSON, the same lane with the port's scalar oracle as the
immediate backend, and the same lane run by JAX-package frontends
through `tests/test_adapter_replay.py`'s `AdapterMirror` on the JAX
package's server.
"""

import pytest

import automerge_tpu as jam
import automerge_tpu_torch as pam
import torch_frontend_cases as FC
from automerge_tpu_torch import errors
from automerge_tpu_torch.sidecar.server import SidecarBackend
from test_adapter_replay import AdapterMirror, SidecarProcess

CHARS, WRITERS = 500, 10


class JaxMirror(AdapterMirror):
    """The JAX test's mirror, with the session's save and load."""

    def save_load(self, state):
        saved = self.conn.request('save', {'doc': state['docId']})
        loaded = self.init()['docId']
        self.conn.request('load', {'doc': loaded,
                                   'data': saved['checkpoint_b64']})
        return self.conn.request('get_patch', {'doc': loaded})


@pytest.fixture(scope='module')
def port_server():
    conn = FC.StdioServer('cpu')
    yield FC.PortMirror(conn, errors)
    conn.close()
    assert conn.proc.returncode == 0


@pytest.fixture(scope='module')
def jax_server():
    conn = SidecarProcess()
    yield JaxMirror(conn)
    conn.close()


LANES = {
    'a-session': lambda am, s: FC.session_lane(am, s),
    'b-typing': lambda am, s: FC.typing_lane(am, s, CHARS)[0],
    'c-conflicts': lambda am, s: FC.conflict_lane(am, s, WRITERS),
}


@pytest.mark.parametrize('lane', sorted(LANES))
def test_port_server_equals_port_oracle(port_server, lane):
    run = LANES[lane]
    assert run(pam, port_server) == run(pam, FC.OracleSurface(pam))


@pytest.mark.parametrize('lane', sorted(LANES))
def test_port_server_equals_jax_server(port_server, jax_server, lane):
    run = LANES[lane]
    assert run(pam, port_server) == run(jam, jax_server)


def test_in_process_sidecar_equals_server():
    """phase 15's lanes (b) and (c) go through `SidecarBackend.handle`
    in process; the transcripts equal the server subprocess's."""
    mirror = FC.PortMirror(FC.InProcess(SidecarBackend(device='cpu')),
                           errors)
    oracle = FC.OracleSurface(pam)
    got, texts, rtt = FC.typing_lane(pam, mirror, CHARS)
    want, want_texts, _ = FC.typing_lane(pam, oracle, CHARS)
    assert got == want and texts == want_texts
    assert texts[0] == texts[1] and len(texts[0]) == CHARS
    assert len(rtt) == CHARS // 50
    assert FC.conflict_lane(pam, mirror, WRITERS) == \
        FC.conflict_lane(pam, oracle, WRITERS)


def test_typed_errors_cross_the_port_wire(port_server):
    state = port_server.init()
    with pytest.raises(TypeError):
        port_server.apply_local_change(state, {'requestType': 'change',
                                               'ops': []})
    state, _ = port_server.apply_local_change(
        state, {'requestType': 'change', 'actor': 'e', 'seq': 1,
                'deps': {}, 'ops': []})
    with pytest.raises(errors.RangeError):
        port_server.apply_local_change(
            state, {'requestType': 'change', 'actor': 'e', 'seq': 1,
                    'deps': {}, 'ops': []})


def test_readpath_arm_on_a_cpu_gateway(tmp_path):
    """`tools/readpath_check.py` arm 1 with the port's clients, backend
    and frontend against a port gateway on the CPU: both clients end
    equal to the gateway's `get_patch`, which equals the oracle's."""
    from automerge_tpu_torch.scheduler import GatewayServer
    path = str(tmp_path / 'r.sock')
    gw = GatewayServer(path, backend=SidecarBackend(device='cpu')).start()
    try:
        end, stats = FC.readpath_arm(pam, path, rounds=8)
    finally:
        gw.stop()
    state, _ = pam.Backend.apply_changes(
        pam.Backend.init(), [FC.read_change(s) for s in range(1, 9)])
    want = pam.Frontend.apply_patch(pam.Frontend.init({'actorId': 'o'}),
                                    pam.Backend.get_patch(state))
    assert end == dict(want) and len(end) == 9
    assert stats['change_wire_bytes'] > 0 and stats['patch_wire_bytes'] > 0

"""Byte parity of the port's native JSON encoder (volcano_tpu_torch/
native/fastmodel.c: ``encode_object_json``, run by
``apiserver/codec.py:dumps_compact`` while ``codec.NATIVE_ENCODE`` is on)
against its own Python body and the reference's ``encode_object`` with the
compact ``json.dumps``, on tests/test_native_encoder.py's cases: dataclass
field order, the ensure_ascii escape table, numeric reprs, str()-ed dict
keys, base64 bytes, containers, and its seeded random trees. The native
engine is the port's default and has no fallback on a failed build: a
shape the C walker does not know is an explicit, counted hand-back.

Tolerance: exact (bytes).
"""

import json
import random

import pytest

from volcano_tpu.apiserver.codec import encode_object as ref_encode_object
from volcano_tpu.models import objects as ref_obj
from volcano_tpu_torch.apiserver import codec
from volcano_tpu_torch.models import objects as obj
from volcano_tpu_torch.models.job_info import _fastmodel


@pytest.fixture
def python_engine():
    codec.NATIVE_ENCODE = False
    yield
    codec.NATIVE_ENCODE = True


def _reference(o) -> bytes:
    return json.dumps(ref_encode_object("any", o),
                      separators=(",", ":")).encode()


def _python_body(o) -> bytes:
    codec.NATIVE_ENCODE = False
    try:
        return codec.dumps_compact(o)
    finally:
        codec.NATIVE_ENCODE = True


def _assert_parity(o, ref=None):
    native = _fastmodel().encode_object_json(o)
    assert native is not None
    assert native == _python_body(o)
    assert codec.dumps_compact(o) == native
    assert native == _reference(o if ref is None else ref)


def _pod(mod, name="p0", ns="ns", node=None, labels=None):
    return mod.Pod(
        metadata=mod.ObjectMeta(name=name, namespace=ns, labels=labels or {}),
        spec=mod.PodSpec(node_name=node))


def test_dataclass_field_order_and_nesting():
    _assert_parity(_pod(obj, "p0", "ns", "node-3", {"app": "solver"}),
                   _pod(ref_obj, "p0", "ns", "node-3", {"app": "solver"}))
    alloc = {"cpu": "8", "memory": "16Gi"}
    _assert_parity(
        obj.Node(metadata=obj.ObjectMeta(name="n0"),
                 status=obj.NodeStatus(allocatable=dict(alloc))),
        ref_obj.Node(metadata=ref_obj.ObjectMeta(name="n0"),
                     status=ref_obj.NodeStatus(allocatable=dict(alloc))))


def test_store_kinds_encode_as_the_reference():
    """Every kind of a synthetic cluster (pods with constraints, nodes
    with zones, groups, queues), built alike by both packages."""
    import volcano_tpu.apiserver.store as ref_store
    import volcano_tpu.utils.synth as ref_synth
    import volcano_tpu_torch.apiserver.store as port_store
    import volcano_tpu_torch.utils.synth as port_synth
    shape = dict(n_nodes=6, n_jobs=5, gang_size=3, zones=2, spread_every=2,
                 anti_every=3)
    ps, rs = port_store.ObjectStore(), ref_store.ObjectStore()
    port_synth.populate_store(ps, **shape)
    ref_synth.populate_store(rs, **shape)
    n = 0
    for kind in sorted(port_store.KINDS):
        mine = sorted(ps.list_refs(kind), key=lambda o: o.metadata.name)
        theirs = sorted(rs.list_refs(kind), key=lambda o: o.metadata.name)
        assert len(mine) == len(theirs)
        for a, b in zip(mine, theirs):
            for o in (a, b):   # each store's own uids and timestamps
                o.metadata.uid = "u"
                o.metadata.creation_timestamp = 1.0
            _assert_parity(a, b)
            n += 1
    assert n > 25


def test_string_escapes_cover_the_ensure_ascii_table():
    _assert_parity({"s": 'quote" back\\slash /slash',
                    "ws": "\n\t\r\b\f",
                    "ctrl": "".join(chr(c) for c in range(0x20)),
                    "del": "\x7f",
                    "bmp": "é€☃￿",
                    "astral": "\U0001F600\U0010FFFF"})


def test_numeric_reprs_match_the_stdlib_encoder():
    _assert_parity({"i": 0, "neg": -42, "big": 2 ** 70,
                    "f": 1.5, "short": 0.1, "tiny": 5e-324,
                    "huge": 1e300, "negzero": -0.0,
                    "nan": float("nan"), "inf": float("inf"),
                    "ninf": float("-inf")})
    _assert_parity({"t": True, "f": False, "n": None})


def test_dict_keys_are_str_ed_in_insertion_order():
    _assert_parity({"z": 1, "a": 2, 5: "int key", "m": 3})


def test_bytes_wrap_as_base64_like_the_codec():
    _assert_parity({"empty": b"", "one": b"a", "two": b"ab",
                    "bin": bytes(range(256)), "secret": b"hunter2"})


def test_containers_and_tuples():
    _assert_parity([1, [2, (3, 4)], {"k": [_pod(obj), _pod(obj, "p1")]}, []],
                   [1, [2, (3, 4)], {"k": [_pod(ref_obj),
                                           _pod(ref_obj, "p1")]}, []])


def test_unknown_shape_is_a_counted_hand_back():
    """A set has no JSON form: the C walker hands the whole value back
    (None, nothing raised), dumps_compact counts it and runs the Python
    body, which raises as json.dumps does."""
    class Weird:
        pass

    assert _fastmodel().encode_object_json({"w": {1, 2}}) is None
    assert _fastmodel().encode_object_json([Weird()]) is None
    before = codec.encode_handbacks
    with pytest.raises(TypeError):
        codec.dumps_compact({"w": {1, 2}})
    assert codec.encode_handbacks == before + 1
    # a shape it knows is never handed back
    pod = _pod(obj, "p9", "ns", "node-1", {"a": "b"})
    codec.dumps_compact(pod)
    assert codec.encode_handbacks == before + 1


def test_python_engine_switch(python_engine):
    """With the switch off the Python body writes the same bytes, and the
    native entry is not called."""
    pod = _pod(obj, "p2", "ns", "node-2")
    calls = []
    fm = _fastmodel()

    class Tap:
        def __getattr__(self, name):
            return getattr(fm, name)

        def encode_object_json(self, o):
            calls.append(o)
            return fm.encode_object_json(o)

    import volcano_tpu_torch.apiserver.codec as c
    saved = c._fastmodel
    c._fastmodel = lambda: Tap()
    try:
        out = codec.dumps_compact(pod)
    finally:
        c._fastmodel = saved
    assert not calls
    assert out == _reference(_pod(ref_obj, "p2", "ns", "node-2"))


def test_wired_encoders_use_it():
    """The WAL's records and the hub's frame bytes are dumps_compact's."""
    from volcano_tpu_torch.apiserver.http import json_object_encoder
    pod = _pod(obj, "p3", "ns", "node-1", {"a": "b"})
    assert json_object_encoder("pods", pod) == codec.dumps_compact(pod)


@pytest.mark.parametrize("seed", [1234, 7, 99])
def test_randomized_object_fuzz(seed):
    rng = random.Random(seed)

    def leaf():
        return rng.choice([
            lambda: rng.randint(-2 ** 40, 2 ** 40),
            lambda: rng.random() * 10 ** rng.randint(-8, 8),
            lambda: "".join(chr(rng.choice(
                [rng.randint(1, 0xd7ff), rng.randint(0xe000, 0x10ffff)]))
                for _ in range(rng.randint(0, 8))),
            lambda: rng.randbytes(rng.randint(0, 12)),
            lambda: rng.choice([True, False, None]),
        ])()

    def tree(depth):
        if depth <= 0:
            return leaf()
        kind = rng.random()
        if kind < 0.4:
            return {f"k{i}": tree(depth - 1)
                    for i in range(rng.randint(0, 4))}
        if kind < 0.7:
            return [tree(depth - 1) for _ in range(rng.randint(0, 4))]
        return leaf()

    for _ in range(200):
        _assert_parity(tree(3))

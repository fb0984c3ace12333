"""Observability utilities."""

import json

from srhmm_tpu.utils import EventLog, Throughput


def test_event_log_jsonl(tmp_path, capsys):
    log = EventLog(tmp_path / "ev.jsonl", echo=False)
    log.emit("hello", a=1)
    with log.span("work", tag="x"):
        pass
    log.close()
    lines = [json.loads(l) for l in (tmp_path / "ev.jsonl").read_text().splitlines()]
    assert lines[0]["event"] == "hello" and lines[0]["a"] == 1
    assert lines[1]["event"] == "work" and "seconds" in lines[1]


def test_throughput_counters():
    tp = Throughput(frame_shift_s=0.01)
    tp.add(num_frames=1000, seconds=0.5)
    assert abs(tp.frames_per_sec - 2000) < 1e-9
    assert abs(tp.audio_seconds_per_sec - 20.0) < 1e-9
    assert abs(tp.rtf - 0.05) < 1e-9


def test_pytree_dataclass_static_fields_and_replace():
    """utils.pytree.dataclass: data fields are leaves, static fields live in
    the treedef (two values give two structures), .replace() returns a new
    frozen instance."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import pytest

    from srhmm_tpu.utils import pytree

    @pytree.dataclass
    class Pair:
        a: jax.Array
        b: jax.Array | None = None
        tag: str = pytree.static_field(default="x")

    p = Pair(a=jnp.ones(2), b=jnp.zeros(3))
    assert len(jax.tree.leaves(p)) == 2
    assert jax.tree.structure(p) != jax.tree.structure(p.replace(tag="y"))
    q = jax.tree.map(lambda x: x + 1, p)
    assert q.tag == "x" and float(q.b[0]) == 1.0
    assert p.replace(b=None).b is None and len(jax.tree.leaves(p.replace(b=None))) == 1
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.a = jnp.zeros(2)
    doubled = jax.jit(lambda t: t.replace(a=t.a * 2))(p)
    assert float(doubled.a[0]) == 2.0 and doubled.tag == "x"

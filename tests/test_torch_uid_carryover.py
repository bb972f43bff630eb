"""The reduced PostFilter parity after uids were drawn before it.

Each package draws object uids from one counter a process, and a
Scheduler's Mirror draws one for each empty ``Pod()`` it packs as a row
template, whose uid it interns. The interned ids key the argmax's tie
perturbation. In a parity test the cluster's objects are JAX-package
objects (uids from the JAX package's counter), so where the port's
counter had been advanced by earlier tests, the port's template could
draw the uid of one of the test's pods, move that pod's interned id, and
pair the preemptors with the freed nodes differently from the reference.

The parity harness of tests/test_torch_preempt.py therefore starts both
sides' counters at one base past every uid drawn
(tests/torch_port_support.py ``uid_base`` / ``start_uids``). The cases
set the two counters where they collided before that:

- ``port_2000``: 2,000 port uids drawn, the JAX package's counter unused;
- ``red_pod``: the port's next uid 1,858 and the JAX package's 1,502, as
  one process left them when it ran test_torch_kernel_layout.py's K6b
  tests without their ``own_counters`` fixture and then
  test_torch_preempt.py: the port's templates drew the uids of red-56 and
  red-57;
- ``preemptor``: the port's templates at the uids of pre-3 and pre-4.

Each case checks the harness's two calls against the parity test's own
objects; the parity test runs whole once, in the case that failed first.
"""

import itertools

import pytest

import kubernetes_tpu.api.objects as jax_objects
import kubernetes_tpu_torch.api.objects as port_objects
from tests import test_torch_preempt as PP
from tests.torch_port_support import start_uids, uid_base

pytestmark = pytest.mark.torch_port

CASES = {"port_2000": (2001, 1, False), "red_pod": (1858, 1502, True),
         "preemptor": (604, 1, True)}


def _set_counters(monkeypatch, port_next, jax_next):
    monkeypatch.setattr(port_objects, "_uid_counter",
                        itertools.count(port_next))
    monkeypatch.setattr(jax_objects, "_uid_counter",
                        itertools.count(jax_next))


@pytest.mark.parametrize("case", list(CASES))
def test_uid_base_keeps_the_templates_off_the_test_objects(monkeypatch,
                                                           case):
    """With the counters where they collided, the parity test's objects
    drawn, the port's next uids name some of them (where the case
    collided); after uid_base / start_uids both packages draw the same
    template uids, and none of the test's."""
    port_next, jax_next, collided = CASES[case]
    _set_counters(monkeypatch, port_next, jax_next)
    script = PP._postfilter_script()
    drawn = {a.metadata.uid for op, a in script if op in ("node", "pod")}
    base = uid_base()
    ahead = {port_objects.Pod().metadata.uid for _ in range(4)}
    assert bool(ahead & drawn) == collided
    templates = []
    for port in (False, True):
        start_uids(port, base)
        mod = port_objects if port else jax_objects
        templates.append([mod.Pod().metadata.uid for _ in range(4)])
    assert templates[0] == templates[1]
    assert not drawn & set(templates[1])


@pytest.mark.parametrize("case", ["red_pod"])
def test_postfilter_parity_after_uids_were_drawn(monkeypatch, case):
    _set_counters(monkeypatch, *CASES[case][:2])
    PP.test_reduced_postfilter_path_matches_jax()

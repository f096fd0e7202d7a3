"""Online liveness of the port's scheduler, and its plans against the
reference's.

``repro.core.scheduler`` grows online requests only by preempting offline
ones, so online requests that together exceed the pool wait for each other
forever once no offline work is left (the reference's hypothesis property
``tests/test_scheduler.py::test_scheduler_liveness_and_conservation`` draws
such cases now and then).  ``repro_torch.core.scheduler`` preempts the most
recently admitted running online request younger than the one that cannot
grow, and resumes it ahead of offline work.  These tests check that every
request then finishes, on the two recorded cases and a seeded sweep, that an
online request is a victim only when no offline one is left, and that a plan
made while all online work fits is the reference's plan.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

from repro.configs import get_config as get_config_ref  # noqa: E402
from repro.core import request as request_ref  # noqa: E402
from repro.core import scheduler as scheduler_ref  # noqa: E402
from repro.core.profiler import A100_40G  # noqa: E402
from repro.core.profiler import AnalyticalCostModel as CostModelRef  # noqa: E402
from repro.core.slo import SLO as SLORef  # noqa: E402
from repro.kvcache.block_manager import BlockManager as BlockManagerRef  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.profiler import AnalyticalCostModel, HardwareSpec  # noqa: E402
from repro_torch.core.request import Phase, Priority, Request  # noqa: E402
from repro_torch.core.scheduler import SchedulerConfig, UnifiedScheduler  # noqa: E402
from repro_torch.core.slo import SLO  # noqa: E402
from repro_torch.kvcache.block_manager import BlockManager  # noqa: E402

CFG = get_config("llama-2-7b")
# the latency model of the reference's property test
A100 = HardwareSpec(**dataclasses.asdict(A100_40G))

# (n_off, n_on, blocks, plen, gen) with online work that never finishes in
# the reference: an example its property test drew, and one with 5 online
# requests on 40 blocks (the size of another drawn example)
RECORDED = [(0, 6, 121, 348, 5), (0, 5, 40, 100, 40)]


def make_sched(blocks):
    return UnifiedScheduler(CFG, AnalyticalCostModel(CFG, A100), SLO(1.5, 0.110),
                            BlockManager(blocks, 4 * blocks, 16), SchedulerConfig())


def make_sched_ref(blocks):
    cfg = get_config_ref("llama-2-7b")
    return scheduler_ref.UnifiedScheduler(
        cfg, CostModelRef(cfg, A100_40G), SLORef(1.5, 0.110),
        BlockManagerRef(blocks, 4 * blocks, 16), scheduler_ref.SchedulerConfig())


def drive(sched, reqs, on_plan=None, max_iters=3000):
    """The reference property test's loop; ``on_plan(plan, running_before)``
    sees every plan.  Returns the number of iterations."""
    for r in reqs:
        sched.submit(r)
    now = 0.0
    for it in range(max_iters):
        before = list(sched.running)
        plan = sched.plan_iteration(now)
        if plan.empty and not (
            sched.online_q or sched.offline_q or sched.running or sched.preempted
        ):
            return it
        if on_plan is not None:
            on_plan(plan, before)
        now += max(sched.model.iter_time(plan.shape), 1e-4)
        sched.commit(plan, now)
        sched.blocks.check_invariants()
    return max_iters


def check_online_victims(plan, running_before):
    """An online request is preempted only after every offline request that
    was running has been (online requests never yield to offline work), and
    never the request that grows (it is in the plan)."""
    victims = plan.preempted
    first = next((i for i, r in enumerate(victims) if r.is_online), None)
    if first is None:
        return
    offline_before = {r.request_id for r in running_before if not r.is_online}
    assert offline_before <= {r.request_id for r in victims[:first]}
    planned = {r.request_id for r in plan.decode_reqs} | {
        c.request.request_id for c in plan.prefill_chunks}
    assert not planned & {r.request_id for r in victims}


def liveness_case(n_off, n_on, blocks, plen, gen):
    sched = make_sched(blocks)
    reqs = [Request(Priority.OFFLINE, plen, gen) for _ in range(n_off)]
    reqs += [Request(Priority.ONLINE, plen, gen) for _ in range(n_on)]
    drive(sched, reqs, check_online_victims)
    assert all(r.phase == Phase.FINISHED for r in reqs)
    assert all(r.num_generated == gen for r in reqs)
    assert sched.blocks.used_device_blocks == 0
    return reqs


@pytest.mark.parametrize("n_off,n_on,blocks,plen,gen", RECORDED)
def test_recorded_online_overflow_cases_finish(n_off, n_on, blocks, plen, gen):
    """Both cases hang in the reference (checked here); the port finishes
    them by preempting online work, which is counted per request."""
    ref = make_sched_ref(blocks)
    ref_reqs = [request_ref.Request(request_ref.Priority.ONLINE, plen, gen)
                for _ in range(n_on)]
    drive(ref, ref_reqs, max_iters=500)
    assert not all(r.phase == request_ref.Phase.FINISHED for r in ref_reqs)
    reqs = liveness_case(n_off, n_on, blocks, plen, gen)
    assert sum(r.num_preemptions for r in reqs) > 0


def sweep_cases(seed, n=60):
    """Seeded draws over the reference property test's ranges, keeping only
    cases in which one sequence fits the pool."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        case = (int(rng.integers(0, 21)), int(rng.integers(0, 9)),
                int(rng.integers(40, 401)), int(rng.integers(1, 601)),
                int(rng.integers(1, 41)))
        if -(-(case[3] + case[4]) // 16) <= case[2]:
            out.append(case)
    return out


@pytest.mark.parametrize("seed", range(4))
def test_liveness_seeded_sweep(seed):
    """Every request of every case finishes exactly once; block accounting
    stays consistent; online victims only once no offline work is left."""
    online_preempted = 0
    for case in sweep_cases(seed, n=150):
        reqs = liveness_case(*case)
        online_preempted += any(r.num_preemptions for r in reqs if r.is_online)
    # each sweep reaches the repair (about one case in 25 does)
    assert online_preempted > 0


def plan_signature(sched, plan, index):
    """A plan's chunks, decodes and victims by request index, and whether
    it resumed a request or preempted an online one: the two places where
    the port's copy plans differently from the reference (its resume fix
    logged in ROADMAP Queue 3, and the online repair)."""
    events = [kind for kind, _req, _payload in sched.events]
    sched.events.clear()
    special = "resume" in events or any(r.is_online for r in plan.preempted)
    sig = ([(index[id(c.request)], c.offset, c.length) for c in plan.prefill_chunks],
           [index[id(r)] for r in plan.decode_reqs],
           [index[id(r)] for r in plan.preempted])
    return sig, special


def plans_of(sched, reqs):
    index = {id(r): i for i, r in enumerate(reqs)}
    out = []
    drive(sched, reqs, lambda plan, _before: out.append(plan_signature(sched, plan, index)))
    return out


@pytest.mark.parametrize("seed", range(2))
def test_plans_match_the_reference_while_online_work_fits(seed):
    """Plan by plan, the port plans as the reference does up to the first
    iteration that resumes a request or preempts an online one; most cases
    have neither, and then every plan matches."""
    whole = 0
    for n_off, n_on, blocks, plen, gen in sweep_cases(100 + seed, n=40):
        port = plans_of(make_sched(blocks),
                        [Request(Priority.OFFLINE, plen, gen) for _ in range(n_off)]
                        + [Request(Priority.ONLINE, plen, gen) for _ in range(n_on)])
        Rr, Pr = request_ref.Request, request_ref.Priority
        ref = plans_of(make_sched_ref(blocks),
                       [Rr(Pr.OFFLINE, plen, gen) for _ in range(n_off)]
                       + [Rr(Pr.ONLINE, plen, gen) for _ in range(n_on)])
        cut = next((i for i, (a, b) in enumerate(zip(port, ref)) if a[1] or b[1]), None)
        if cut is None:
            whole += 1
            assert [s for s, _ in port] == [s for s, _ in ref]
        else:
            assert [s for s, _ in port[:cut]] == [s for s, _ in ref[:cut]]
    assert whole >= 20

"""Port parity for the pipeline schedules and the layer partitioner:
``deepspeed_tpu_torch.pipe.schedule`` and
``deepspeed_tpu_torch.parallel.partition`` (the port's own copies) give
the JAX package's instruction streams and partitions exactly, over a
grid of micro-batches × stages; ``tests/test_pipe_schedule.py``'s and
``tests/test_partition.py``'s cases run on the port; and the port's
``GPipeSchedule`` (every forward, then every backward) pairs each send
with its receive on one step, as the interpreter needs.  Pure Python: no
device, no process group."""
import numpy as np
import pytest

from deepspeed_tpu_torch.parallel import partition as P
from deepspeed_tpu_torch.pipe import schedule as S

GRID = [(m, s) for m in (1, 2, 3, 4, 5, 8, 16) for s in (1, 2, 3, 4, 8)]


def _flat(sched):
    return [c for step in sched for c in step]


def _count(sched, cls):
    return sum(1 for c in _flat(sched) if isinstance(c, cls))


def _streams(mod, cls, micros, stages):
    return [[[repr(c) for c in step]
             for step in getattr(mod, cls)(micros, stages, s).steps()]
            for s in range(stages)]


@pytest.mark.parametrize("cls", ["TrainSchedule", "InferenceSchedule",
                                 "DataParallelSchedule"])
def test_streams_equal_jax_package(cls):
    from deepspeed_tpu.pipe import schedule as J
    for micros, stages in GRID:
        if cls == "DataParallelSchedule" and stages != 1:
            continue
        assert _streams(S, cls, micros, stages) == \
            _streams(J, cls, micros, stages), (cls, micros, stages)
        for s in range(stages):
            assert (getattr(S, cls)(micros, stages, s).num_pipe_buffers()
                    == getattr(J, cls)(micros, stages, s)
                    .num_pipe_buffers())


def test_partitions_equal_jax_package():
    from deepspeed_tpu.parallel import partition as JP
    rng = np.random.default_rng(0)
    for _ in range(200):
        n = int(rng.integers(0, 40))
        k = int(rng.integers(1, 10))
        w = rng.random(n).tolist()
        assert P.partition_balanced(w, k) == JP.partition_balanced(w, k)
        assert P.partition_uniform(n, k) == JP.partition_uniform(n, k)
        assert P.prefix_sum_inc(w) == JP.prefix_sum_inc(w)


# ---------------------------------------------------------------------------
# tests/test_pipe_schedule.py on the port
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cls", ["TrainSchedule", "GPipeSchedule"])
@pytest.mark.parametrize("micros,stages", [(1, 1), (4, 2), (8, 4), (3, 4)])
def test_train_schedule_full_coverage(cls, micros, stages):
    """Every stage forwards and backwards every micro-batch exactly once."""
    for stage in range(stages):
        cmds = _flat(getattr(S, cls)(micros, stages, stage))
        assert sum(isinstance(c, S.ForwardPass) for c in cmds) == micros
        assert sum(isinstance(c, S.BackwardPass) for c in cmds) == micros
        assert sum(isinstance(c, S.OptimizerStep) for c in cmds) == 1
        assert sum(isinstance(c, S.ReduceGrads) for c in cmds) == 1
        assert sum(isinstance(c, S.ReduceTiedGrads) for c in cmds) == 1


@pytest.mark.parametrize("cls", ["TrainSchedule", "GPipeSchedule"])
def test_train_schedule_step_count(cls):
    s = getattr(S, cls)(micro_batches=4, stages=2, stage_id=0)
    assert len(list(s.steps())) == 2 * (4 + 2 - 1)


@pytest.mark.parametrize("cls", ["TrainSchedule", "GPipeSchedule"])
@pytest.mark.parametrize("micros,stages", [(4, 3), (1, 2), (16, 4), (3, 8)])
def test_send_recv_pairing(cls, micros, stages):
    """Stage s sends exactly as many activations as stage s+1 receives,
    and every send lands on the step of its matching receive (the
    interpreter posts a step's sends and receives together)."""
    steps = [list(getattr(S, cls)(micros, stages, s).steps())
             for s in range(stages)]
    for s in range(stages - 1):
        assert sum(isinstance(c, S.SendActivation) for step in steps[s]
                   for c in step) == micros
        assert sum(isinstance(c, S.RecvActivation) for step in steps[s + 1]
                   for c in step) == micros
        assert sum(isinstance(c, S.SendGrad) for step in steps[s + 1]
                   for c in step) == micros
        assert sum(isinstance(c, S.RecvGrad) for step in steps[s]
                   for c in step) == micros
        for t in range(len(steps[s])):
            assert sum(isinstance(c, S.SendActivation)
                       for c in steps[s][t]) == sum(
                isinstance(c, S.RecvActivation) for c in steps[s + 1][t])
            assert sum(isinstance(c, S.SendGrad)
                       for c in steps[s + 1][t]) == sum(
                isinstance(c, S.RecvGrad) for c in steps[s][t])


def test_first_last_stage_no_external_comm():
    micros, stages = 4, 3
    first = S.TrainSchedule(micros, stages, 0)
    last = S.TrainSchedule(micros, stages, stages - 1)
    assert _count(first, S.RecvActivation) == 0
    assert _count(first, S.SendGrad) == 0
    assert _count(last, S.SendActivation) == 0
    assert _count(last, S.RecvGrad) == 0
    assert _count(first, S.LoadMicroBatch) == micros
    assert _count(last, S.LoadMicroBatch) == micros
    assert _count(S.TrainSchedule(micros, stages, 1), S.LoadMicroBatch) == 0


@pytest.mark.parametrize("cls", ["TrainSchedule", "GPipeSchedule"])
def test_forward_before_backward_per_micro(cls):
    s = getattr(S, cls)(micro_batches=4, stages=2, stage_id=1)
    seen_fwd = set()
    for c in _flat(s):
        if isinstance(c, S.ForwardPass):
            seen_fwd.add(c.buffer_id)
        if isinstance(c, S.BackwardPass):
            assert c.buffer_id in seen_fwd


def test_buffer_count():
    assert S.TrainSchedule(8, 4, 0).num_pipe_buffers() == 5
    assert S.TrainSchedule(8, 4, 3).num_pipe_buffers() == 2
    assert S.TrainSchedule(1, 4, 0).num_pipe_buffers() == 2
    assert S.GPipeSchedule(8, 4, 0).num_pipe_buffers() == 8


@pytest.mark.parametrize("micros,stages", [(4, 2), (16, 4), (3, 3)])
def test_live_buffers_bounded(micros, stages):
    """Replaying a stream, the buffers holding a forwarded, not yet
    backwarded micro-batch never exceed ``num_pipe_buffers()`` under
    1F1B, and a buffer is never reused while live; GPipe holds all M."""
    for s in range(stages):
        for cls in ("TrainSchedule", "GPipeSchedule"):
            sched = getattr(S, cls)(micros, stages, s)
            live, peak = set(), 0
            for c in _flat(sched):
                if isinstance(c, S.ForwardPass):
                    assert c.buffer_id not in live
                    live.add(c.buffer_id)
                    peak = max(peak, len(live))
                elif isinstance(c, S.BackwardPass):
                    live.remove(c.buffer_id)
            assert peak <= sched.num_pipe_buffers()
            if cls == "TrainSchedule":
                assert peak == min(stages - s, micros)
            else:
                assert peak == micros


def test_inference_schedule():
    for stage in range(2):
        cmds = _flat(S.InferenceSchedule(4, 2, stage))
        assert sum(isinstance(c, S.ForwardPass) for c in cmds) == 4
        assert sum(isinstance(c, S.BackwardPass) for c in cmds) == 0


def test_data_parallel_schedule():
    cmds = _flat(S.DataParallelSchedule(micro_batches=3, stages=1,
                                        stage_id=0))
    assert sum(isinstance(c, S.ForwardPass) for c in cmds) == 3
    assert sum(isinstance(c, S.OptimizerStep) for c in cmds) == 1


@pytest.mark.parametrize("cls", ["TrainSchedule", "GPipeSchedule",
                                 "InferenceSchedule"])
def test_invalid_stage_raises(cls):
    with pytest.raises(ValueError):
        getattr(S, cls)(4, 2, 5)


# ---------------------------------------------------------------------------
# tests/test_partition.py on the port
# ---------------------------------------------------------------------------
def _max_part(weights, parts):
    return max(sum(weights[parts[p]:parts[p + 1]])
               for p in range(len(parts) - 1))


def test_uniform_exact():
    assert P.partition_uniform(8, 4) == [0, 2, 4, 6, 8]


def test_uniform_remainder_front_loaded():
    parts = P.partition_uniform(10, 4)
    sizes = [parts[i + 1] - parts[i] for i in range(4)]
    assert sum(sizes) == 10
    assert max(sizes) - min(sizes) <= 1


def test_balanced_uniform_weights():
    parts = P.partition_balanced([1.0] * 8, 4)
    assert [parts[i + 1] - parts[i] for i in range(4)] == [2, 2, 2, 2]


def test_balanced_skewed():
    w = [10.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0]
    assert _max_part(w, P.partition_balanced(w, 2)) == 10.0


def test_balanced_monotone_boundaries():
    rng = np.random.default_rng(0)
    for _ in range(20):
        n = int(rng.integers(1, 40))
        k = int(rng.integers(1, 10))
        parts = P.partition_balanced(rng.random(n).tolist(), k)
        assert len(parts) == k + 1
        assert parts[0] == 0 and parts[-1] == n
        assert all(parts[i] <= parts[i + 1] for i in range(k))


def test_balanced_near_optimal():
    w = np.random.default_rng(1).random(32).tolist()
    parts = P.partition_balanced(w, 4)
    assert _max_part(w, parts) <= max(max(w), sum(w) / 4) + max(w)


def test_more_parts_than_items():
    parts = P.partition_balanced([1.0, 1.0], 4)
    assert parts[0] == 0 and parts[-1] == 2
    assert len(parts) == 5

"""Pipeline schedules as data — a copy of ``deepspeed_tpu/pipe/schedule.py``
(pure Python; the port keeps its own copy), plus :class:`GPipeSchedule`.

Behavioral port of the reference schedule generators
(reference: deepspeed/runtime/pipe/schedule.py — TrainSchedule:182-289,
InferenceSchedule:129-179, DataParallelSchedule:292-314, instruction
vocabulary :317-474).

Unlike the JAX engine, which traces the whole schedule into one SPMD
program, the port's engine (``pipe/engine.py``) INTERPRETS these streams
the way the reference's ``_exec_schedule`` does: each process runs its
own stage's instructions one step after another, the forward and
backward passes as autograd on the stage's layers and the sends and
receives as ``torch.distributed`` point-to-point calls on the pipe
group.  Every send is deferred one step so that it falls on the step of
its matching receive; the interpreter posts a step's sends and receives
together.
"""
from __future__ import annotations

from typing import Iterable, List


# ---------------------------------------------------------------------------
# instruction vocabulary
# ---------------------------------------------------------------------------
class PipeInstruction:
    def __init__(self, **kwargs):
        self.name = self.__class__.__name__
        self.kwargs = kwargs
        for k, v in kwargs.items():
            setattr(self, k, v)

    def __repr__(self):
        if self.kwargs:
            args = ", ".join(f"{k}={v}" for k, v in sorted(self.kwargs.items()))
            return f"{self.name}({args})"
        return self.name

    def __eq__(self, other):
        return (isinstance(other, PipeInstruction)
                and self.name == other.name and self.kwargs == other.kwargs)

    def __hash__(self):
        return hash((self.name, tuple(sorted(self.kwargs.items()))))


class OptimizerStep(PipeInstruction):
    pass


class ReduceGrads(PipeInstruction):
    pass


class ReduceTiedGrads(PipeInstruction):
    pass


class LoadMicroBatch(PipeInstruction):
    def __init__(self, buffer_id: int):
        super().__init__(buffer_id=buffer_id)


class BufferOpInstruction(PipeInstruction):
    def __init__(self, buffer_id: int):
        super().__init__(buffer_id=buffer_id)


class ForwardPass(BufferOpInstruction):
    pass


class BackwardPass(BufferOpInstruction):
    pass


class SendActivation(BufferOpInstruction):
    pass


class RecvActivation(BufferOpInstruction):
    pass


class SendGrad(BufferOpInstruction):
    pass


class RecvGrad(BufferOpInstruction):
    pass


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------
class PipeSchedule:
    """Base: yields a list of PipeInstruction per step for one stage."""

    def __init__(self, micro_batches: int, stages: int, stage_id: int):
        if not 0 <= stage_id < stages:
            raise ValueError(f"stage_id {stage_id} out of range [0,{stages})")
        self.micro_batches = micro_batches
        self.stages = stages
        self.stage_id = stage_id
        self.prev_stage = stage_id - 1
        self.next_stage = stage_id + 1

    def steps(self) -> Iterable[List[PipeInstruction]]:
        raise NotImplementedError

    def num_pipe_buffers(self) -> int:
        raise NotImplementedError

    @property
    def is_first_stage(self):
        return self.stage_id == 0

    @property
    def is_last_stage(self):
        return self.stage_id == self.stages - 1

    def _valid_micro_batch(self, micro_batch_id: int) -> bool:
        return 0 <= micro_batch_id < self.micro_batches

    def _buffer_idx(self, micro_batch_id: int) -> int:
        return micro_batch_id % self.num_pipe_buffers()

    def __iter__(self):
        return iter(self.steps())


class InferenceSchedule(PipeSchedule):
    """Forward-only fill/drain (reference: schedule.py:129-179)."""

    def num_pipe_buffers(self) -> int:
        return 2

    def steps(self):
        total_steps = self.micro_batches + self.stages - 1
        prev_buf = None  # deferred send, as in TrainSchedule
        for step_id in range(total_steps):
            micro_batch_id = step_id - self.stage_id
            cmds: List[PipeInstruction] = []
            valid = self._valid_micro_batch(micro_batch_id)
            buf = micro_batch_id % self.num_pipe_buffers() if valid else 0
            if prev_buf is not None and not self.is_last_stage:
                cmds.append(SendActivation(prev_buf))
            prev_buf = None
            if valid and not self.is_first_stage:
                cmds.append(RecvActivation(buf))
            if valid and (self.is_first_stage or self.is_last_stage):
                cmds.append(LoadMicroBatch(buf))
            if valid:
                cmds.append(ForwardPass(buf))
                prev_buf = buf
            yield cmds


class TrainSchedule(PipeSchedule):
    """1F1B-interleaved fill/drain (reference: schedule.py:182-289).

    2*(micro_batches + stages - 1) total steps; even steps are forward-ish,
    odd steps backward-ish, with the even/odd phase offset per stage
    (_step_to_micro_batch, reference :249-289)."""

    def num_pipe_buffers(self) -> int:
        # min(stages - stage_id + 1, micro_batches) (reference :243-247)
        buffers = min(self.stages - self.stage_id + 1, self.micro_batches)
        return max(2, buffers)

    def _step_to_micro_batch(self, step_id: int):
        """Map a schedule tick to (micro_batch_id, is_forward).

        Closed form of the 1F1B timetable: stage ``s`` runs the forward of
        micro ``m`` at step ``s + 2m`` and its backward at step
        ``(2*stages - 1 - s) + 2m``.  Forward steps share the stage's
        parity; backward steps the opposite parity — so each step holds at
        most one compute, alternating 1F1B in steady state.
        """
        s, S = self.stage_id, self.stages
        if (step_id - s) % 2 == 0:
            return (step_id - s) // 2, True
        return (step_id - (2 * S - 1 - s)) // 2, False

    def steps(self):
        """Sends are DEFERRED one step (reference: schedule.py:200-232): the
        activation/grad produced at step t is sent at step t+1, which is
        exactly when the neighbor's Recv fires — stage s forwards micro m at
        step s+2m and sends at s+2m+1 = (s+1)+2m, the very step stage s+1
        issues RecvActivation(m).  A rendezvous-p2p interpreter therefore
        pairs every Send/Recv on the same tick."""
        total_steps = 2 * (self.micro_batches + self.stages - 1)
        pending_send = None  # (buf, was_forward) produced last step
        for step_id in range(total_steps):
            micro_batch_id, is_forward = self._step_to_micro_batch(step_id)
            valid = self._valid_micro_batch(micro_batch_id)
            cmds: List[PipeInstruction] = []
            buf = self._buffer_idx(micro_batch_id) if valid else 0

            if pending_send is not None:
                pbuf, pfwd = pending_send
                if pfwd and not self.is_last_stage:
                    cmds.append(SendActivation(pbuf))
                elif not pfwd and not self.is_first_stage:
                    cmds.append(SendGrad(pbuf))
                pending_send = None

            if valid:
                if is_forward:
                    if not self.is_first_stage:
                        cmds.append(RecvActivation(buf))
                    if self.is_first_stage or self.is_last_stage:
                        cmds.append(LoadMicroBatch(buf))
                    cmds.append(ForwardPass(buf))
                else:
                    if not self.is_last_stage:
                        cmds.append(RecvGrad(buf))
                    cmds.append(BackwardPass(buf))
                pending_send = (buf, is_forward)

            # optimizer epilogue at the very end
            if step_id == total_steps - 1:
                cmds.append(ReduceTiedGrads())
                cmds.append(ReduceGrads())
                cmds.append(OptimizerStep())

            yield cmds


class DataParallelSchedule(PipeSchedule):
    """Degenerate single-stage schedule (reference: schedule.py:292-314)."""

    def num_pipe_buffers(self) -> int:
        return 1

    def steps(self):
        for micro_batch_id in range(self.micro_batches):
            cmds: List[PipeInstruction] = [
                LoadMicroBatch(0), ForwardPass(0), BackwardPass(0),
            ]
            if micro_batch_id == self.micro_batches - 1:
                cmds.extend([ReduceGrads(), OptimizerStep()])
            yield cmds


class GPipeSchedule(PipeSchedule):
    """Every forward first, then every backward (the GPipe order): stage
    ``s`` forwards micro ``m`` at step ``s + m`` and runs its backward at
    step ``(M + S - 1) + (S - 1 - s) + m``.  Sends are deferred one step as
    in :class:`TrainSchedule`, so each falls on its receive's step.  All
    ``M`` boundary inputs stay live until the backward sweep."""

    def num_pipe_buffers(self) -> int:
        return max(1, self.micro_batches)

    def steps(self):
        M, S, s = self.micro_batches, self.stages, self.stage_id
        fwd_steps = M + S - 1
        total_steps = 2 * fwd_steps
        pending_send = None
        for step_id in range(total_steps):
            if step_id < fwd_steps:
                micro_batch_id, is_forward = step_id - s, True
            else:
                micro_batch_id = step_id - fwd_steps - (S - 1 - s)
                is_forward = False
            valid = self._valid_micro_batch(micro_batch_id)
            cmds: List[PipeInstruction] = []
            buf = self._buffer_idx(micro_batch_id) if valid else 0
            if pending_send is not None:
                pbuf, pfwd = pending_send
                if pfwd and not self.is_last_stage:
                    cmds.append(SendActivation(pbuf))
                elif not pfwd and not self.is_first_stage:
                    cmds.append(SendGrad(pbuf))
                pending_send = None
            if valid:
                if is_forward:
                    if not self.is_first_stage:
                        cmds.append(RecvActivation(buf))
                    if self.is_first_stage or self.is_last_stage:
                        cmds.append(LoadMicroBatch(buf))
                    cmds.append(ForwardPass(buf))
                else:
                    if not self.is_last_stage:
                        cmds.append(RecvGrad(buf))
                    cmds.append(BackwardPass(buf))
                pending_send = (buf, is_forward)
            if step_id == total_steps - 1:
                cmds.append(ReduceTiedGrads())
                cmds.append(ReduceGrads())
                cmds.append(OptimizerStep())
            yield cmds

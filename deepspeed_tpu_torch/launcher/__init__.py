"""Launcher (reference feature slot: deepspeed/launcher/ + bin/ds).

The port has the supervision helpers the serving fleet's router shares
with the elastic agent (``supervise``).  The hostfile runner, the
per-node launcher and the elastic agent come with ROADMAP.md queue 1
item 14.
"""

"""Executor layer (port of ``cruise_control_tpu.executor``): so far only what
the continuous controller needs -- the proposal journal encoding and the
``OngoingExecutionError`` its drain catches.  The executor engine (task
planning, southbound calls, the execution journal) is not ported yet."""

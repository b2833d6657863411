"""Monitor layer (port of ``cruise_control_tpu.monitor``): so far only what
the continuous controller reads -- the completeness requirements and the
window-delta event.  The load monitor itself (sampling, aggregation, model
construction) is not ported yet."""

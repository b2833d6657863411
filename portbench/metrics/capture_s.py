"""``capture_s``: the host seconds the device loop took to capture the goal
graphs and their rounds in this run (``DeviceLoops.capture_s``, the
program's counter), read after the warm-up, whose first call captures every
graph the window launches.  Layer: the device loop."""


def before_window(run):
    if run.device.type == "cuda":
        from cruise_control_tpu_torch.analyzer.device_loop import device_loops

        run.notes["capture_s"] = device_loops(run.device).capture_s


def read(run):
    return run.notes.get("capture_s")

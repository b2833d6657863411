"""``python -m cruise_control_tpu_torch --config cruisecontrol.properties [--device cpu]``

Port of ``cruise_control_tpu/__main__.py``, the process entry point
(KafkaCruiseControlMain.java:26).  The JAX entry probes its accelerator before
importing the app, because that import touches the device; importing the port
touches none, so :func:`~cruise_control_tpu_torch.app.main` probes the device
itself.  Help and doc invocations return before the probe.
"""

import sys

from cruise_control_tpu_torch.app import main

if __name__ == "__main__":
    sys.exit(main())

"""Replicated read plane: WAL-tailing followers and the watch hub.

Port of ``cruise_control_tpu/replication`` (the state and the follower; the
JAX package's ``bench`` spawns the HTTP app and waits for the app's port).
The standing proposal set is a versioned, journaled, crash-recoverable
value, and it is the replication unit: follower processes tail the
controller WAL with :meth:`~cruise_control_tpu_torch.core.journal.Journal.tail`
and fold the records into a
:class:`~cruise_control_tpu_torch.replication.state.ReplicationState`; the
writer feeds its own state through the journal's listener with the same
records.  All of it runs on the host: a follower never touches the device.
"""

from cruise_control_tpu_torch.replication.follower import FollowerTailer
from cruise_control_tpu_torch.replication.state import ReplicationState

__all__ = ["FollowerTailer", "ReplicationState"]

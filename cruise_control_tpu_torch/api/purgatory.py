"""Two-step verification for POST requests.

Port of ``cruise_control_tpu/api/purgatory.py`` (pure Python, copied whole).

Counterpart of ``servlet/purgatory/`` (2-step-verification wiki doc): when enabled,
state-changing POSTs are parked as ``RequestInfo`` in PENDING_REVIEW; an approver
hits the REVIEW endpoint to APPROVE (or DISCARD); the original request re-submitted
with the review id then executes (SUBMITTED).
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
import threading
import time
from typing import Dict, List, Optional, Tuple


class ReviewStatus(enum.Enum):
    PENDING_REVIEW = "PENDING_REVIEW"
    APPROVED = "APPROVED"
    SUBMITTED = "SUBMITTED"
    DISCARDED = "DISCARDED"


@dataclasses.dataclass
class RequestInfo:
    review_id: int
    endpoint: str
    params: Dict
    submitter: str
    status: ReviewStatus = ReviewStatus.PENDING_REVIEW
    reason: str = ""
    submitted_ms: int = dataclasses.field(
        default_factory=lambda: int(time.time() * 1000)
    )

    def to_dict(self) -> dict:
        return {
            "Id": self.review_id,
            "EndPoint": self.endpoint,
            "Params": self.params,
            "Submitter": self.submitter,
            "Status": self.status.value,
            "Reason": self.reason,
            "SubmitTimeMs": self.submitted_ms,
        }


class Purgatory:
    def __init__(self, retention_ms: int = 7 * 24 * 3600 * 1000) -> None:
        self._requests: Dict[int, RequestInfo] = {}
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self.retention_ms = retention_ms

    def park(self, endpoint: str, params: Dict, submitter: str = "anonymous") -> RequestInfo:
        with self._lock:
            info = RequestInfo(next(self._ids), endpoint, params, submitter)
            self._requests[info.review_id] = info
            return info

    def review(
        self, approve_ids: List[int] = (), discard_ids: List[int] = (), reason: str = ""
    ) -> List[RequestInfo]:
        """The REVIEW endpoint's approve/discard action."""
        with self._lock:
            out = []
            for rid in approve_ids:
                info = self._requests.get(rid)
                if info and info.status is ReviewStatus.PENDING_REVIEW:
                    info.status = ReviewStatus.APPROVED
                    info.reason = reason
                    out.append(info)
            for rid in discard_ids:
                info = self._requests.get(rid)
                if info and info.status in (
                    ReviewStatus.PENDING_REVIEW, ReviewStatus.APPROVED
                ):
                    info.status = ReviewStatus.DISCARDED
                    info.reason = reason
                    out.append(info)
            return out

    def take_approved(self, review_id: int, endpoint: str) -> Optional[RequestInfo]:
        """Claim an APPROVED request for execution (marks SUBMITTED)."""
        with self._lock:
            info = self._requests.get(review_id)
            if info and info.status is ReviewStatus.APPROVED and info.endpoint == endpoint:
                info.status = ReviewStatus.SUBMITTED
                return info
            return None

    def board(self) -> List[RequestInfo]:
        """REVIEW_BOARD listing."""
        now = int(time.time() * 1000)
        with self._lock:
            self._requests = {
                rid: r
                for rid, r in self._requests.items()
                if now - r.submitted_ms < self.retention_ms
            }
            return sorted(self._requests.values(), key=lambda r: r.review_id)

"""Restart policy tracking (reference: client/restarts.go).

Decides whether and when to restart an exited task based on the task group's
RestartPolicy, with jitter, interval windows, and the delay-vs-fail modes.

Copied from nomad_tpu/client/restarts.py; only the imports differ.
"""

from __future__ import annotations

import random
import time
from typing import Optional, Tuple

from nomad_tpu_torch.structs import RestartPolicy
from nomad_tpu_torch.structs.structs import (
    JobTypeBatch,
    JobTypeService,
    RestartPolicyModeDelay,
    RestartPolicyModeFail,
    ns_to_seconds,
)

# Decisions (reference: restarts.go:14-21)
NO_RESTART = "no-restart"
RESTART_WAIT = "restart-wait"


class RestartTracker:
    def __init__(self, policy: RestartPolicy, job_type: str,
                 rng: Optional[random.Random] = None):
        self.policy = policy
        self.job_type = job_type
        self.rng = rng or random.Random()
        self.count = 0
        self.start_time = 0.0
        self._wait_time = 0.0
        self._last_exit_success = False

    def set_policy(self, policy: RestartPolicy) -> None:
        self.policy = policy

    def next_restart(self, exit_code: int) -> Tuple[str, float]:
        """Decide (decision, wait_seconds) for an exited task
        (reference: restarts.go:85-147 GetState)."""
        now = time.time()
        # Batch jobs that exited cleanly don't restart.
        if self.job_type == JobTypeBatch and exit_code == 0:
            return NO_RESTART, 0.0

        interval = ns_to_seconds(self.policy.Interval)
        if self.start_time == 0.0 or (interval > 0
                                      and now - self.start_time > interval):
            # New interval window.
            self.start_time = now
            self.count = 0

        self.count += 1
        if self.policy.Attempts > 0 and self.count <= self.policy.Attempts:
            return RESTART_WAIT, self._jitter()

        # Attempts exhausted within the interval.
        if self.policy.Mode == RestartPolicyModeFail:
            return NO_RESTART, 0.0
        if self.policy.Mode == RestartPolicyModeDelay:
            # Wait until the interval rolls over, then restart.
            remaining = max(0.0, (self.start_time + interval) - now)
            self.count = 0
            self.start_time = now + remaining
            return RESTART_WAIT, remaining + self._jitter()
        return NO_RESTART, 0.0

    def _jitter(self) -> float:
        """Delay +/- 25% jitter (reference: restarts.go:150-156)."""
        delay = ns_to_seconds(self.policy.Delay)
        if delay <= 0:
            return 0.0
        return delay + self.rng.random() * delay * 0.25

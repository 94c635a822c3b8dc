"""Job submission: run driver scripts against a cluster from outside it.

Reference: ``dashboard/modules/job/job_manager.py:525`` (job lifecycle),
``job_head.py`` (REST API), ``python/ray/dashboard/modules/job/sdk.py``
(JobSubmissionClient) and ``ray job submit`` CLI.
"""

from .client import JobSubmissionClient  # noqa: F401
from .manager import JobManager, JobStatus  # noqa: F401

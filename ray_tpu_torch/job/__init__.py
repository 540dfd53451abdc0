from ray_tpu_torch.job.job_manager import (JobInfo, JobManager, JobStatus,
                                           JobSubmissionClient)

__all__ = ["JobManager", "JobSubmissionClient", "JobStatus", "JobInfo"]

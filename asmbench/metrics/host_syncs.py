"""Host syncs: the operations that made the host wait for the device
(``.item()``, a copy to the host, a boolean mask, ...), counted under
``--profile-stages`` from PyTorch's sync debug mode, the program's own
barriers left out.  The mean rise a job of the ``host_syncs`` counter,
from ``counts`` in the job's ``stats`` line: one count a job, so a sync
inside a part is not counted again for its span.  None where a job's line
has no such counter."""


def read(run):
    per_job = []
    for job in run.jobs:
        syncs = ((job.stats or {}).get("counts") or {}).get("host_syncs")
        if syncs is None:
            return None
        per_job.append(syncs)
    return sum(per_job) / len(per_job) if per_job else None

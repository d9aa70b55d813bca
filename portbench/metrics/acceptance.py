"""acceptance: accepted drafts over drafted tokens of the window's jobs
(the program's SpecStats counters), in %."""


def read(run):
    drafted = sum(j.drafted for j in run.jobs)
    if not drafted:
        return None
    return 100.0 * sum(j.accepted for j in run.jobs) / drafted

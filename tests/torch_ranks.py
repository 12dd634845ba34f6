"""Rank processes for the port's data-parallel tests: a test file run as a
script ``WORLD`` times, the ranks meeting at a ``file://`` store under a
work directory, each with a timeout so that a rank that dies fails the
test instead of hanging it."""

import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORLD = 2
RANK_TIMEOUT_S = 300
# the variables a rank reads to find its process group: none may leak in
# from the test's own environment
GROUP_ENV = ("S3G_COORDINATOR", "S3G_NUM_PROCESSES", "S3G_PROCESS_ID",
             "MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")


class Ranks:
    """``script rank store workdir`` started once per rank, each writing
    its output to ``rank<r>.log`` in the work directory (a pipe could fill
    while its rank waits in a collective); ``wait()`` collects them,
    failing with a rank's output if it fails."""

    def __init__(self, script, workdir, env=()):
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   PYTHONPATH=os.pathsep.join([REPO, HERE]), **dict(env))
        for k in GROUP_ENV:
            env.pop(k, None)
        store = "file://" + os.path.join(str(workdir), "store")
        self.logs = [os.path.join(str(workdir), f"rank{r}.log")
                     for r in range(WORLD)]
        self.procs = []
        for r, log in enumerate(self.logs):
            with open(log, "w") as f:
                self.procs.append(subprocess.Popen(
                    [sys.executable, script, str(r), store, str(workdir)],
                    cwd=REPO, env=env, stdout=f, stderr=subprocess.STDOUT))
        self.outputs = None

    def wait(self, timeout=RANK_TIMEOUT_S):
        if self.outputs is None:
            deadline = time.monotonic() + timeout
            try:
                for p in self.procs:
                    p.wait(timeout=max(0.0, deadline - time.monotonic()))
            finally:
                self.kill()
                self.outputs = []
                for log in self.logs:
                    with open(log) as f:
                        self.outputs.append(f.read())
            for r, (p, out) in enumerate(zip(self.procs, self.outputs)):
                assert p.returncode == 0, \
                    f"rank {r} exited {p.returncode}:\n{out}"
        return self.outputs

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()

"""The reference's workload-consuming e2e (tests/test_e2e_workload.py) on
the port: a fake MPI job whose tasks run as real processes under the
port's ProcessKubelet (volcano_tpu_torch/utils/process_kubelet.py) and
whose completion depends on what the port's svc and ssh job plugins
produced (tests/fake_mpi_workload.py: the master reads the rendered
worker hostfile and signs each worker's launch token with the ssh
Secret's private key; each worker verifies it against authorized_keys).
The four cases, through the port's admission, controllers and scheduler
(on the CPU): the job completes; a SIGKILLed worker under RestartTask
and under RestartJob; a tampered keypair fails the job.
"""

from tests.torch_reference_cases import port_cases

# the controllers' cases first: the workload's module imports its CONF
# and make_job from them
port_cases("test_controllers")
_workload = port_cases("test_e2e_workload", replace=[
    ("from tests.test_controllers import",
     "from tests._port_test_controllers import"),
    ("ssn = open_session(self.cache, self.conf.tiers,\n"
     "                           self.conf.configurations)",
     "ssn = open_session(self.cache, self.conf.tiers,\n"
     "                           self.conf.configurations, device=\"cpu\")")])

cl = _workload.cl
test_mpi_job_completes_through_hostfile_and_keypair = \
    _workload.test_mpi_job_completes_through_hostfile_and_keypair
test_killed_worker_restart_task_policy = \
    _workload.test_killed_worker_restart_task_policy
test_killed_worker_restart_job_policy = \
    _workload.test_killed_worker_restart_job_policy
test_tampered_keypair_fails_job = _workload.test_tampered_keypair_fails_job

"""Process launcher: ``python -m paddle_tpu_torch.distributed.launch train.py``.

Counterpart of ``paddle_tpu/distributed/launch.py`` (reference
python/paddle/distributed/fleet/launch.py:304 + distributed/utils.py:357
``start_local_trainers`` / :417 ``watch_local_trainers``), its JAX-free
code kept here.  The port runs one process per card, as the reference
does: ``--nproc_per_node N`` starts N trainers on this host, each with
the fleet env contract set (``PADDLE_TRAINER_ID``,
``PADDLE_TRAINERS_NUM``, ``PADDLE_COORDINATOR``,
``PADDLE_TRAINER_ENDPOINTS``) and its card in ``FLAGS_selected_gpus``
(the JAX launcher exports ``FLAGS_selected_tpus``: one process drives
every chip there).  ``PADDLE_DISTRI_BACKEND`` passes through from the
launcher's environment (``distributed/parallel_env.py``).
"""
from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time


def _parse_args(argv=None):
    p = argparse.ArgumentParser("paddle_tpu_torch.distributed.launch")
    p.add_argument("--ips", type=str, default="127.0.0.1",
                   help="comma list of host ips")
    p.add_argument("--nproc_per_node", type=int, default=1,
                   help="trainer processes on THIS node, one a card")
    p.add_argument("--coordinator_port", type=int, default=37777)
    p.add_argument("--log_dir", type=str, default=None)
    p.add_argument("training_script", type=str)
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def start_local_trainers(nproc, coordinator, script, script_args, log_dir=None,
                         base_rank=0, total=None, selected_gpus=None):
    """Spawn trainer subprocesses with the fleet env contract set
    (reference utils.py:357).  ``selected_gpus``: each local trainer's
    card (default: the i-th trainer on card i)."""
    procs = []
    total = total if total is not None else nproc
    gpus = list(selected_gpus) if selected_gpus is not None \
        else list(range(nproc))
    if len(gpus) != nproc:
        raise ValueError(f"selected_gpus names {len(gpus)} cards for "
                         f"{nproc} trainers")
    for i in range(nproc):
        rank = base_rank + i
        env = dict(os.environ)
        env.update({
            "PADDLE_TRAINER_ID": str(rank),
            "PADDLE_TRAINERS_NUM": str(total),
            "PADDLE_COORDINATOR": coordinator,
            "PADDLE_TRAINER_ENDPOINTS": coordinator,
            "FLAGS_selected_gpus": str(gpus[i]),
        })
        out = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            out = open(os.path.join(log_dir, f"workerlog.{rank}"), "w")
        procs.append(subprocess.Popen(
            [sys.executable, script] + list(script_args),
            env=env, stdout=out, stderr=subprocess.STDOUT if out else None))
    return procs


def watch_local_trainers(procs):
    """Poll children; tear the job down if any dies
    (reference utils.py:417 watch + :257 terminate)."""
    try:
        while True:
            alive = False
            for p in procs:
                ret = p.poll()
                if ret is None:
                    alive = True
                elif ret != 0:
                    terminate_local_procs(procs)
                    return ret
            if not alive:
                return 0
            time.sleep(0.5)
    except KeyboardInterrupt:
        terminate_local_procs(procs)
        return 1


def terminate_local_procs(procs):
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    deadline = time.time() + 5
    for p in procs:
        while p.poll() is None and time.time() < deadline:
            time.sleep(0.1)
        if p.poll() is None:
            p.kill()
            p.wait()


def launch(argv=None):
    args = _parse_args(argv)
    ips = [h for h in args.ips.split(",") if h]
    me = os.environ.get("POD_IP")
    if len(ips) > 1:
        if me is None or me not in ips:
            raise SystemExit(
                "multi-host launch needs POD_IP set to this host's entry in "
                f"--ips (got POD_IP={me!r}, ips={ips}); otherwise every host "
                "would claim node rank 0 and the rendezvous fails")
    else:
        me = ips[0]
    node_rank = ips.index(me)
    coordinator = f"{ips[0]}:{args.coordinator_port}"
    total = len(ips) * args.nproc_per_node
    procs = start_local_trainers(
        args.nproc_per_node, coordinator, args.training_script,
        args.training_script_args, log_dir=args.log_dir,
        base_rank=node_rank * args.nproc_per_node, total=total)
    sys.exit(watch_local_trainers(procs))


if __name__ == "__main__":
    launch()

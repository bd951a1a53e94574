"""PyTorch port: the training launchers (scripts/torch_train_single_host.sh,
torch_train_multi_host.sh, torch_slurm_train.sbatch) on the CPU, without a
card and without SLURM.

Each parses (``bash -n``). Each runs with fake programs first on PATH that
record their argv and environment: ``torchrun`` (or, when no torchrun is on
PATH, ``python -m torch.distributed.run``), ``python`` for the JAX scripts
(and for the count of visible GPUs), ``srun`` and ``scontrol``. The trainer
arguments each twin hands to ``us_video_medsam2_tpu_torch.apps.train`` must
be the ones its JAX script hands to ``us_video_medsam2_tpu.apps.train``:
the recipe, the positional arguments, ``--init_ckpt`` only when given. The
torchrun arguments: ``--standalone`` and one process a visible GPU on one
host; ``--nnodes/--node_rank/--master_addr/--master_port`` across hosts,
the SLURM node's rank read inside the srun'd command. The launchers exec
their command (so SIGTERM reaches the trainer), and the SLURM script's trap
requeues the job on SIGTERM.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
RECORDER = """#!/usr/bin/env bash
if [ "$(basename "$0")" = python ] && [ "${1:-}" = -c ]; then echo "${FAKE_GPUS:-0}"; exit 0; fi
if [ "$(basename "$0")" = srun ]; then sleep "${FAKE_SRUN_SLEEP:-0}"; exec "$@"; fi
{
  echo "prog=$(basename "$0")"
  echo "pid=$$"
  for a in "$@"; do printf 'arg=%s\\n' "$a"; done
  env | grep -E '^(MASTER_|JAX_|SLURM_)' | sort | sed 's/^/env=/'
} >> "$RECORD"
if [ "$(basename "$0")" = scontrol ] && [ "${1:-}" = show ]; then printf 'node0\\nnode1\\n'; fi
exit 0
"""
LAUNCHERS = ["torch_train_single_host.sh", "torch_train_multi_host.sh", "torch_slurm_train.sbatch"]
RECIPE = ["--epochs", "100", "--num_frames", "4", "--max_num_objects", "5", "--curriculum", "quantum",
          "--temporal_loss", "consistency"]


@pytest.fixture
def fakes(tmp_path):
    """A bin directory of recorders and a record file."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    for prog in ("torchrun", "python", "srun", "scontrol"):
        p = bin_dir / prog
        p.write_text(RECORDER)
        p.chmod(0o755)
    return bin_dir, tmp_path / "record.txt"


def run(script, args, fakes, env=None, with_torchrun=True, popen=False):
    bin_dir, record = fakes
    if not with_torchrun:
        (bin_dir / "torchrun").unlink()
    e = {k: v for k, v in os.environ.items() if not k.startswith(("SLURM_", "MASTER_", "NNODES", "NODE_RANK",
                                                                   "NPROC_PER_NODE", "PYTHON", "JAX_"))}
    e.update(PATH=f"{bin_dir}:/usr/bin:/bin", RECORD=str(record), **(env or {}))
    cmd = ["bash", os.path.join(SCRIPTS, script), *args]
    if popen:
        return subprocess.Popen(cmd, env=e, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return subprocess.run(cmd, env=e, capture_output=True, text=True, timeout=60)


def records(fakes) -> list:
    """[{prog, pid, args, env}] in the order the fakes ran."""
    out = []
    for line in fakes[1].read_text().splitlines():
        k, _, v = line.partition("=")
        if k == "prog":
            out.append({"prog": v, "args": [], "env": {}})
        elif k == "pid":
            out[-1]["pid"] = int(v)
        elif k == "arg":
            out[-1]["args"].append(v)
        else:
            name, _, val = v.partition("=")
            out[-1]["env"][name] = val
    return out


def trainer_args(args, module):
    i = args.index(module)
    assert args[i - 1] == "-m"
    return args[:i - 1], args[i + 1:]


@pytest.mark.parametrize("script", LAUNCHERS)
def test_parses(script):
    assert subprocess.run(["bash", "-n", os.path.join(SCRIPTS, script)]).returncode == 0
    assert os.access(os.path.join(SCRIPTS, script), os.X_OK)
    with open(os.path.join(SCRIPTS, script)) as f:
        src = f.read()
    assert "us_video_medsam2_tpu_torch.apps.train" in src and "exec " in src


@pytest.mark.parametrize("ckpt", ["init.pt", None])
@pytest.mark.parametrize("script, jax_script", [("torch_train_single_host.sh", "train_single_host.sh"),
                                                ("torch_train_multi_host.sh", "train_multi_host.sh")])
def test_recipe_matches_jax(fakes, script, jax_script, ckpt):
    multi = {"NNODES": "2", "NODE_RANK": "1", "MASTER_ADDR": "host0"} if "multi" in script else {}
    pos = ["/data/d", "/out/o"] + ([ckpt] if ckpt else [])
    p = run(jax_script, pos, fakes)
    assert p.returncode == 0, p.stderr
    p = run(script, pos, fakes, env={"FAKE_GPUS": "4", **multi})
    assert p.returncode == 0, p.stderr
    jax_rec, rec = records(fakes)
    assert jax_rec["prog"] == "python" and rec["prog"] == "torchrun"
    _, want = trainer_args(jax_rec["args"], "us_video_medsam2_tpu.apps.train")
    launch, got = trainer_args(rec["args"], "us_video_medsam2_tpu_torch.apps.train")
    assert got == want == ["--data_dir", "/data/d", "--out_dir", "/out/o", *RECIPE] + (
        ["--init_ckpt", ckpt] if ckpt else [])
    if multi:
        assert launch == ["--nnodes=2", "--node_rank=1", "--nproc_per_node=4", "--master_addr=host0",
                          "--master_port=29500"]
    else:
        assert launch == ["--standalone", "--nproc_per_node=4"]


def test_single_host_overrides_and_fallback(fakes):
    p = run("torch_train_single_host.sh", ["/d", "/o", "", "--epochs", "1", "--device", "cpu"], fakes,
            env={"NPROC_PER_NODE": "2"}, with_torchrun=False)
    assert p.returncode == 0, p.stderr
    (rec,) = records(fakes)
    assert rec["prog"] == "python"  # python -m torch.distributed.run
    assert rec["args"][:4] == ["-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2"]
    _, got = trainer_args(rec["args"][2:], "us_video_medsam2_tpu_torch.apps.train")
    assert got == ["--data_dir", "/d", "--out_dir", "/o", *RECIPE, "--epochs", "1", "--device", "cpu"]
    assert "--init_ckpt" not in got


def test_no_visible_gpu_and_missing_settings(fakes):
    p = run("torch_train_single_host.sh", ["/d", "/o"], fakes, env={"FAKE_GPUS": "0"})
    assert p.returncode == 1 and "no visible GPU" in p.stderr
    p = run("torch_train_single_host.sh", [], fakes)
    assert p.returncode != 0 and "usage" in p.stderr
    p = run("torch_train_single_host.sh", ["/d"], fakes)
    assert p.returncode != 0 and "2: parameter null or not set" in p.stderr  # as the JAX script
    p = run("torch_train_multi_host.sh", ["/d", "/o"], fakes, env={"FAKE_GPUS": "1", "NODE_RANK": "0",
                                                                  "MASTER_ADDR": "h"})
    assert p.returncode != 0 and "NNODES" in p.stderr
    assert not fakes[1].exists()  # nothing was launched
    # the real count of visible GPUs through torch
    p = run("torch_train_single_host.sh", ["/d", "/o"], fakes, env={"PYTHON": sys.executable})
    import torch

    n = torch.cuda.device_count()
    assert (p.returncode == 0) == (n > 0)
    if n:
        assert records(fakes)[0]["args"][1] == f"--nproc_per_node={n}"


@pytest.mark.parametrize("ckpt", ["init.pt", None])
def test_slurm_matches_jax(fakes, ckpt):
    env = {"DATA_DIR": "/d", "OUT_DIR": "/o", "EPOCHS": "7", "SLURM_JOB_NODELIST": "node[0-1]",
           "SLURM_JOB_ID": "42", "SLURM_NNODES": "2", "SLURM_NTASKS": "2", "SLURM_NODEID": "1",
           "SLURM_PROCID": "1", "FAKE_GPUS": "8"}
    if ckpt:
        env["INIT_CKPT"] = ckpt
    for script in ("slurm_train.sbatch", "torch_slurm_train.sbatch"):
        p = run(script, [], fakes, env=env)
        assert p.returncode == 0, p.stderr
    shows = [r for r in records(fakes) if r["prog"] == "scontrol"]
    assert [r["args"] for r in shows] == [["show", "hostnames", "node[0-1]"]] * 2
    jax_rec, rec = [r for r in records(fakes) if r["prog"] != "scontrol"]
    _, want = trainer_args(jax_rec["args"], "us_video_medsam2_tpu.apps.train")
    launch, got = trainer_args(rec["args"], "us_video_medsam2_tpu_torch.apps.train")
    assert got == want == ["--data_dir", "/d", "--out_dir", "/o", "--epochs", "7", "--num_frames", "4",
                           "--max_num_objects", "5", "--curriculum", "quantum"] + (
        ["--init_ckpt", ckpt] if ckpt else [])
    # the rendezvous read inside the srun'd command: this task's node, the first host as master
    assert jax_rec["env"]["JAX_PROCESS_ID"] == "1" and jax_rec["env"]["JAX_COORDINATOR_ADDRESS"] == "node0:12355"
    assert launch == ["--nnodes=2", "--node_rank=1", "--nproc_per_node=8", "--master_addr=node0",
                      "--master_port=12355"]
    with open(os.path.join(SCRIPTS, "torch_slurm_train.sbatch")) as f:
        head = [x for x in f.read().splitlines() if x.startswith("#SBATCH")]
    assert "#SBATCH --requeue" in head and "#SBATCH --signal=B:TERM@120" in head


def test_launchers_exec_their_command(fakes):
    """The fake torchrun's pid is the launcher's own: no bash stays between
    SIGTERM and the trainer."""
    p = run("torch_train_single_host.sh", ["/d", "/o"], fakes, env={"FAKE_GPUS": "1"}, popen=True)
    assert p.wait(timeout=60) == 0
    (rec,) = records(fakes)
    assert rec["pid"] == p.pid
    fakes[1].unlink()
    p = run("torch_train_multi_host.sh", ["/d", "/o"], fakes, popen=True,
            env={"FAKE_GPUS": "1", "NNODES": "1", "NODE_RANK": "0", "MASTER_ADDR": "localhost"})
    assert p.wait(timeout=60) == 0
    assert records(fakes)[0]["pid"] == p.pid


def test_slurm_requeues_on_sigterm(fakes):
    env = {"DATA_DIR": "/d", "OUT_DIR": "/o", "SLURM_JOB_NODELIST": "node0", "SLURM_JOB_ID": "77",
           "SLURM_NNODES": "1", "SLURM_NODEID": "0", "FAKE_GPUS": "1", "FAKE_SRUN_SLEEP": "3"}
    p = run("torch_slurm_train.sbatch", [], fakes, env=env, popen=True)
    deadline = time.time() + 30
    while not fakes[1].exists() and time.time() < deadline:  # scontrol show hostnames has run
        time.sleep(0.05)
    time.sleep(0.5)
    p.send_signal(signal.SIGTERM)
    p.wait(timeout=60)
    requeues = [r["args"] for r in records(fakes) if r["prog"] == "scontrol" and r["args"][0] == "requeue"]
    assert requeues == [["requeue", "77"]]

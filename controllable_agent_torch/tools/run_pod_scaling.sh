#!/usr/bin/env bash
# Scaling over several hosts of cards: the port's counterpart of the JAX
# package's tools/run_pod_scaling.sh. Run ONE copy on EVERY host, one card
# per host: (a) host 0 measures the data-parallel updates/s on its own cards
# (bench_scaling), then (b) every host joins the same offline FB run over
# the whole group (train_multihost: NCCL, each host its shard of the
# episode files), and (c) host 0 prints the single-host rate to compare the
# multi-host run's train.csv with.
#
# Usage (per host, from any directory):
#   EXORL_DIR=/data/rnd_walker \
#     bash controllable_agent_torch/tools/run_pod_scaling.sh <coordinator_host:port> <num_hosts> <host_id>
#
# Requirements: the repo on every host, the same PyTorch with CUDA, one card
# per host, and EXORL_DIR holding ExORL .npz episodes with a physics key on
# every host. Outputs go to exp_pod/ in the repo.
set -euo pipefail

COORD=${1:?coordinator host:port}
NHOSTS=${2:?number of hosts}
HOSTID=${3:?this host id (0-based)}
BATCH=${BATCH:-1024}
STEPS=${STEPS:-100}

cd "$(dirname "$0")/../.."
mkdir -p exp_pod

# (a) single-host baseline (host 0 only, its own cards)
if [ "$HOSTID" = "0" ]; then
  python -m controllable_agent_torch.tools.bench_scaling --batch "$BATCH" --steps "$STEPS" \
      | tee exp_pod/scaling_single_host.jsonl
fi

# (b) the offline FB recipe over every host's card: each host loads its shard
# of the episodes, the gradients are summed over the group
python -m controllable_agent_torch.train_multihost \
    agent=fb_ddpg task=walker_walk goal_space=walker_pos_speed_z \
    replay_dir="${EXORL_DIR:?set EXORL_DIR to an ExORL episode dir}" \
    coordinator="$COORD" num_processes="$NHOSTS" process_id="$HOSTID" \
    num_grad_steps=2000 steps_per_call=200 eval_every_steps=100000 \
    final_tests=0 folder="exp_pod/scaling_${NHOSTS}hosts" \
    agent.batch_size="$BATCH"

# (c) host 0: the single-host updates/s beside the multi-host run's
if [ "$HOSTID" = "0" ]; then
  python - <<'EOF'
import json
single = [json.loads(line) for line in open("exp_pod/scaling_single_host.jsonl")
          if line.startswith("{")]
rate1 = next(r["value"] for r in single if r.get("devices") == 1)
print(json.dumps({
    "note": "compare with exp_pod/scaling_*hosts train.csv fps columns",
    "single_host_updates_per_s": rate1,
    "efficiency_target": 0.8,
}))
EOF
fi

#!/usr/bin/env bash
# Launch marqo-tpu (parity: reference run_marqo.sh:38-100 — external vs
# co-deployed vector-store selection via env vars, partial-config
# validation, store health-wait before the API starts, shutdown trap).
#
# External store (any of these set => ALL must be set consistently):
#   MARQO_ENGINE_QUERY_URL    — engine shard server URL (reference
#                               VESPA_QUERY_URL/DOCUMENT_URL roles)
#   MARQO_ENGINE_CLUSTER      — JSON [[shard replicas...], ...] topology
#                               (mutually exclusive with QUERY_URL)
# Co-deployed (neither set): an engine server starts in this container and
# the API talks to it in-process.
#
# Cross-replica coordination (reference ZOOKEEPER_HOSTS / Redis roles):
#   MARQO_COORDINATION_BACKEND=in_process|file|engine
#   MARQO_COORDINATION_URL    — engine server hosting locks/semaphores
#
# Persistence: MARQO_ENGINE_DATA_DIR (settings + engine snapshots).
# Model warmup: MARQO_MODELS_TO_PRELOAD (JSON list).
set -euo pipefail

PORT="${MARQO_PORT:-8882}"
HOST="${MARQO_HOST:-0.0.0.0}"
ENGINE_PORT="${MARQO_ENGINE_PORT:-8080}"

ENGINE_PID=""
shutdown() {
    echo "Shutting down marqo-tpu..."
    if [[ -n "${ENGINE_PID}" ]]; then
        kill "${ENGINE_PID}" 2>/dev/null || true
    fi
    exit 0
}
trap shutdown SIGTERM SIGINT

if [[ "${1:-}" == "engine" ]]; then
    # standalone engine shard role (reference: external Vespa content node)
    echo "Starting marqo-tpu engine shard on :${ENGINE_PORT}"
    exec python -m marqo_tpu_torch.engine.server --port "${ENGINE_PORT}"
fi

if [[ -n "${MARQO_ENGINE_QUERY_URL:-}" && -n "${MARQO_ENGINE_CLUSTER:-}" ]]; then
    echo "Error: both MARQO_ENGINE_QUERY_URL and MARQO_ENGINE_CLUSTER are" \
         "set. Configure a single external engine OR a cluster topology," \
         "not both. See docs: configuration." >&2
    exit 1
fi

if [[ -z "${MARQO_ENGINE_QUERY_URL:-}" && -z "${MARQO_ENGINE_CLUSTER:-}" ]]; then
    echo "External vector store not configured. Using local vector store" \
         "(in-process engine)."
else
    STORE_URL="${MARQO_ENGINE_QUERY_URL:-}"
    if [[ -z "${STORE_URL}" ]]; then
        # first replica of the first shard of the cluster topology
        STORE_URL=$(python - <<'PY'
import json, os
print(json.loads(os.environ["MARQO_ENGINE_CLUSTER"])[0][0])
PY
)
    fi
    echo "Waiting for external vector store at ${STORE_URL}..."
    for i in $(seq 1 30); do
        if python - "$STORE_URL" <<'PY'
import sys, urllib.request
try:
    urllib.request.urlopen(sys.argv[1].rstrip("/") + "/engine/health",
                           timeout=2)
except Exception:
    sys.exit(1)
PY
        then
            echo "  Vector store is available."
            break
        fi
        if [[ $i -eq 30 ]]; then
            echo "Warning: vector store not reachable after 30 attempts." \
                 "Marqo may not function correctly." >&2
        fi
        sleep 2
    done
fi

echo "Starting marqo-tpu API on ${HOST}:${PORT}"
exec python -c "from marqo_tpu_torch.api.app import main; main(host='${HOST}', port=${PORT})"

"""The port's container image and manifests (``Dockerfile.torch``,
``deploy/k8s-torch.yaml``) stay structurally valid.

No docker, kubectl or network here, so these are static checks, as
``tests/test_deploy.py`` makes of the JAX package's: the manifest parses
and carries the reference layout's load-bearing pieces, every pod runs
the port's image, only the search nodes ask for a card, and the image
installs PyTorch without jax, builds the kernels and the tokenizer at
build time and runs the port's entry point. The image's build itself is
not run here.
"""

import os
import re

import pytest

yaml = pytest.importorskip("yaml")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "tfidf_tpu_torch")
IMAGE = "tfidf-torch:latest"
CONNECT = ",".join(f"tfidf-coordinator-{i}.tfidf-coordinator-peers:2181"
                   for i in range(3))


@pytest.fixture(scope="module")
def docs():
    with open(os.path.join(ROOT, "deploy", "k8s-torch.yaml")) as f:
        return [d for d in yaml.safe_load_all(f) if d]


@pytest.fixture(scope="module")
def dockerfile():
    with open(os.path.join(ROOT, "Dockerfile.torch")) as f:
        return f.read()


def _instructions(dockerfile: str, word: str) -> list[str]:
    """The Dockerfile's ``word`` instructions, continuation lines
    joined."""
    joined = re.sub(r"\\\n\s*", " ", dockerfile)
    return [line[len(word) + 1:] for line in joined.splitlines()
            if line.startswith(word + " ")]


def _deployments(docs):
    return {d["metadata"]["name"]: d for d in docs
            if d["kind"] == "Deployment"}


def _pods(docs):
    """Every pod template: name -> pod spec."""
    out = {}
    for d in docs:
        if d["kind"] in ("Deployment", "StatefulSet"):
            out[d["metadata"]["name"]] = d["spec"]["template"]["spec"]
    return out


def _env(pod):
    return {e["name"]: e for e in pod["containers"][0].get("env", [])}


def _port_env_names() -> set[str]:
    """TFIDF_* names the port reads: one per Config field (the generic
    env loop of ``load_config``) and the literals its code reads (the
    CLI's ``TFIDF_DEVICE``, the kernel build directory)."""
    from tfidf_tpu_torch.utils.config import Config
    names = {f"TFIDF_{f.upper()}" for f in Config.__dataclass_fields__}
    for dirpath, _dirs, files in os.walk(PKG):
        for fn in files:
            if fn.endswith(".py"):
                with open(os.path.join(dirpath, fn),
                          encoding="utf-8") as f:
                    names |= set(re.findall(r'"(TFIDF_[A-Z0-9_]+)"',
                                            f.read()))
    return names


def _package_source() -> str:
    src = ""
    for dirpath, _dirs, files in os.walk(PKG):
        for fn in files:
            if fn.endswith(".py"):
                with open(os.path.join(dirpath, fn),
                          encoding="utf-8") as f:
                    src += f.read()
    return src


def test_k8s_manifest_structure(docs):
    kinds = sorted(d["kind"] for d in docs)
    assert kinds == ["Deployment", "Deployment",
                     "HorizontalPodAutoscaler", "HorizontalPodAutoscaler",
                     "Namespace",
                     "PodDisruptionBudget", "PodDisruptionBudget",
                     "PodDisruptionBudget",
                     "Service", "Service", "Service", "Service",
                     "StatefulSet"]
    ns = next(d for d in docs if d["kind"] == "Namespace")
    assert all(d["metadata"].get("namespace") == ns["metadata"]["name"]
               for d in docs if d["kind"] != "Namespace")
    deployments = _deployments(docs)
    assert set(deployments) == {"tfidf-node", "tfidf-router"}
    node = deployments["tfidf-node"]["spec"]
    assert node["replicas"] == 3
    pod = node["template"]["spec"]
    rule = pod["affinity"]["podAntiAffinity"][
        "requiredDuringSchedulingIgnoredDuringExecution"][0]
    assert rule["topologyKey"] == "kubernetes.io/hostname"
    env = _env(pod)
    assert env["TFIDF_HOST"]["valueFrom"]["fieldRef"][
        "fieldPath"] == "status.podIP"
    assert env["TFIDF_COORDINATOR_ADDRESS"]["value"] == CONNECT
    assert env["TFIDF_EMBEDDING_ENABLED"]["value"] == "true"
    assert env["TFIDF_EMBEDDING_MODEL"]["value"] == "hash"
    mounts = {m["name"]: m["mountPath"]
              for m in pod["containers"][0]["volumeMounts"]}
    assert mounts == {"documents": "/app/documents", "index": "/app/index"}
    assert {v["name"] for v in pod["volumes"]} == {"documents", "index"}
    probe = pod["containers"][0]["readinessProbe"]["httpGet"]
    assert probe["path"] == "/api/ready" and probe["port"] == 8085


def test_k8s_autopilot_enabled_with_clamps(docs):
    env = {k: v.get("value")
           for k, v in _env(_pods(docs)["tfidf-node"]).items()}
    assert "TFIDF_SCATTER_HEDGE_MS" not in env
    assert env["TFIDF_AUTOPILOT_ENABLED"] == "true"
    floor = float(env["TFIDF_AUTOPILOT_HEDGE_FLOOR_MS"])
    ceil = float(env["TFIDF_AUTOPILOT_HEDGE_CEILING_MS"])
    assert 0 < floor < ceil
    assert float(env["TFIDF_AUTOPILOT_P99_SLO_MS"]) > 0


def test_k8s_coordinator_ensemble(docs):
    sts = [d for d in docs if d["kind"] == "StatefulSet"]
    assert len(sts) == 1
    assert sts[0]["metadata"]["name"] == "tfidf-coordinator"
    spec = sts[0]["spec"]
    assert spec["replicas"] == 3
    headless = [d for d in docs if d["kind"] == "Service"
                and d["metadata"]["name"] == spec["serviceName"]]
    assert headless and headless[0]["spec"].get("clusterIP") == "None"
    pod = spec["template"]["spec"]
    rule = pod["affinity"]["podAntiAffinity"][
        "requiredDuringSchedulingIgnoredDuringExecution"][0]
    assert rule["topologyKey"] == "kubernetes.io/hostname"
    args = " ".join(pod["containers"][0]["args"])
    assert "python -m tfidf_tpu_torch coordinator" in args
    assert "--data-dir /data" in args and "--node-id" in args
    for i in range(3):
        assert (f"tfidf-coordinator-{i}=tfidf-coordinator-{i}"
                f".tfidf-coordinator-peers:2181") in args
    assert "data" in {t["metadata"]["name"]
                      for t in spec["volumeClaimTemplates"]}
    mounts = {m["name"]: m["mountPath"]
              for m in pod["containers"][0]["volumeMounts"]}
    assert mounts["data"] == "/data"
    probe = pod["containers"][0]["readinessProbe"]["httpGet"]
    assert probe["path"] == "/ensemble/status"


def test_k8s_hpa_autoscaling(docs):
    hpas = {d["spec"]["scaleTargetRef"]["name"]: d for d in docs
            if d["kind"] == "HorizontalPodAutoscaler"}
    assert set(hpas) == {"tfidf-node", "tfidf-router"}
    spec = hpas["tfidf-node"]["spec"]
    node = _deployments(docs)["tfidf-node"]
    assert spec["minReplicas"] == node["spec"]["replicas"]
    assert spec["maxReplicas"] > spec["minReplicas"]
    names = {m["pods"]["metric"]["name"] for m in spec["metrics"]
             if m["type"] == "Pods"}
    assert names == {"tfidf_last_scatter_queue_depth",
                     "tfidf_index_size_bytes"}
    # the series the HPA keys on are gauges the port emits
    src = _package_source()
    assert '"index_size_bytes"' in src
    assert '_queue_depth"' in src and 'name="scatter"' in src
    assert spec["behavior"]["scaleDown"][
        "stabilizationWindowSeconds"] >= 300


def test_k8s_router_tier(docs):
    router = _deployments(docs)["tfidf-router"]
    spec = router["spec"]
    assert spec["replicas"] >= 2
    pod = spec["template"]["spec"]
    c = pod["containers"][0]
    assert c["args"] == ["router"]
    assert "volumes" not in pod and "volumeMounts" not in c
    env = _env(pod)
    assert env["TFIDF_COORDINATOR_ADDRESS"]["value"] == CONNECT
    assert env["TFIDF_HOST"]["valueFrom"]["fieldRef"][
        "fieldPath"] == "status.podIP"
    ann = spec["template"]["metadata"]["annotations"]
    assert ann["prometheus.io/scrape"] == "true"
    assert ann["prometheus.io/path"] == "/metrics"
    svc = [d for d in docs if d["kind"] == "Service"
           and d["metadata"]["name"] == "tfidf-router"]
    assert svc and svc[0]["spec"]["selector"] == {"app": "tfidf-router"}
    hpa = next(d for d in docs if d["kind"] == "HorizontalPodAutoscaler"
               and d["spec"]["scaleTargetRef"]["name"] == "tfidf-router")
    assert hpa["spec"]["minReplicas"] == spec["replicas"]
    names = {m["pods"]["metric"]["name"] for m in hpa["spec"]["metrics"]
             if m["type"] == "Pods"}
    assert names == {"tfidf_last_router_scatter_queue_depth"}
    with open(os.path.join(PKG, "cluster", "router.py"),
              encoding="utf-8") as f:
        assert 'name="router_scatter"' in f.read()


def test_k8s_rolling_upgrade_budget(docs):
    deployments = _deployments(docs)
    for name, dep in deployments.items():
        strat = dep["spec"]["strategy"]
        assert strat["type"] == "RollingUpdate", name
        assert strat["rollingUpdate"]["maxUnavailable"] == 1, name
    pdbs = {d["metadata"]["name"]: d["spec"] for d in docs
            if d["kind"] == "PodDisruptionBudget"}
    assert set(pdbs) == {"tfidf-coordinator", "tfidf-node", "tfidf-router"}
    for name, spec in pdbs.items():
        assert spec["selector"]["matchLabels"] == {"app": name}, name
    sts = next(d for d in docs if d["kind"] == "StatefulSet")
    assert pdbs["tfidf-coordinator"]["minAvailable"] >= (
        sts["spec"]["replicas"] // 2 + 1)
    node = deployments["tfidf-node"]
    env = {k: v.get("value") for k, v in _env(
        node["spec"]["template"]["spec"]).items()}
    rf = int(env["TFIDF_REPLICATION_FACTOR"])
    assert rf <= pdbs["tfidf-node"]["minAvailable"] < node["spec"][
        "replicas"]
    router = deployments["tfidf-router"]
    assert 1 <= pdbs["tfidf-router"]["minAvailable"] < router["spec"][
        "replicas"]


def test_dockerfile_structure(dockerfile):
    assert "COPY tfidf_tpu_torch ./tfidf_tpu_torch" in dockerfile
    assert "COPY pyproject.toml README.md ./" in dockerfile
    assert 'ENTRYPOINT ["python", "-m", "tfidf_tpu_torch"]' in dockerfile
    assert 'CMD ["serve"]' in dockerfile
    assert "EXPOSE 8085" in dockerfile
    assert 'VOLUME ["/app/documents", "/app/index"]' in dockerfile
    for want in ("TFIDF_DOCUMENTS_PATH=/app/documents",
                 "TFIDF_INDEX_PATH=/app/index", "TFIDF_PORT=8085"):
        assert want in dockerfile, want


def test_every_pod_runs_the_port_s_image(docs):
    for name, pod in _pods(docs).items():
        for c in pod["containers"]:
            assert c["image"] == IMAGE, name
            text = " ".join(c.get("args", []) + c.get("command", []))
            assert "tfidf_tpu " not in text + " ", name


def test_card_requested_only_by_search_nodes(docs):
    pods = _pods(docs)
    for name, pod in pods.items():
        limits = pod["containers"][0].get("resources", {}).get(
            "limits", {})
        tolerated = {t["key"] for t in pod.get("tolerations", [])}
        if name == "tfidf-node":
            assert limits.get("nvidia.com/gpu") == 1
            assert "nvidia.com/gpu" in tolerated
            assert _env(pod)["TFIDF_DEVICE"]["value"] == "cuda"
        else:
            assert "nvidia.com/gpu" not in limits, name
            assert "nvidia.com/gpu" not in tolerated, name
            assert "TFIDF_DEVICE" not in _env(pod), name


def test_manifest_env_names_are_read_by_the_port(docs, dockerfile):
    known = _port_env_names()
    for name, pod in _pods(docs).items():
        for var in _env(pod):
            if var == "POD_NAME":
                continue
            assert var in known, (name, var)
    for var in re.findall(r"\b(TFIDF_[A-Z0-9_]+)=", dockerfile):
        assert var in known, var


def test_image_installs_torch_without_jax(dockerfile):
    base = re.search(r"^FROM\s+(\S+)", dockerfile, re.M).group(1)
    assert base.startswith("nvidia/cuda:12.") and "devel" in base
    assert "ubuntu24.04" in base          # its python3 is 3.12
    # nvidia/cuda has Ubuntu 24.04 images from CUDA 12.5 on
    release = re.match(r"nvidia/cuda:(\d+)\.(\d+)\.\d+-", base)
    assert release and (int(release[1]), int(release[2])) >= (12, 5), base
    installs = " ".join(r for r in _instructions(dockerfile, "RUN")
                        if "pip install" in r)
    # the PyTorch wheels built for the base's CUDA release
    assert "torch" in installs
    assert f"/whl/cu{release[1]}{release[2]} " in installs, installs
    assert "numpy" in installs and "scipy" in installs
    assert "jax" not in installs
    assert "COPY tfidf_tpu " not in dockerfile
    assert not re.search(r"COPY\s+tfidf_tpu\s", dockerfile)


def test_image_builds_kernels_and_tokenizer(dockerfile):
    """No node compiles at boot: ``kernels.build_all()`` (nvcc, no card
    needed) and the native tokenizer (g++) run in a build step."""
    run_steps = " ".join(_instructions(dockerfile, "RUN"))
    assert "kernels.build_all()" in run_steps
    assert "native" in run_steps and "available()" in run_steps
    assert "g++" in dockerfile
    from tfidf_tpu_torch import kernels
    assert hasattr(kernels, "build_all") and kernels.SOURCES

"""Kubernetes pod discovery driving the subscriber manager.

Counterpart of the reference's controller-runtime reconciler
(examples/kv_events/pod_reconciler/pod_reconciler.go:86-188): watch pods
matching a label selector; a Running+Ready pod with an IP gets a ZMQ
subscriber at ``tcp://<podIP>:<port>``, anything else (deleted, not
ready, IP-less) gets its subscriber removed.

The image ships no kubernetes client, so this speaks the watch API
directly over stdlib HTTP — in-cluster service-account auth, list to a
``resourceVersion``, then a chunked ``?watch=true`` stream of
ADDED/MODIFIED/DELETED JSON lines, re-listing on 410 Gone.  The same
predicates run either way, so tests drive it with a plain fake API
server.

Copied from the JAX reference's ``kvevents/pod_reconciler.py``.
"""

from __future__ import annotations

import json
import os
import socket
import ssl
import threading
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import dataclass
from typing import Dict, Optional

from llm_d_kv_cache_manager_tpu_torch.kvevents.subscriber_manager import (
    SubscriberManager,
)
from llm_d_kv_cache_manager_tpu_torch.utils.logging import get_logger

logger = get_logger("kvevents.pod_reconciler")

SERVICE_ACCOUNT_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"
# The fleet's serving pods carry this label (reference: pool.go:35).
DEFAULT_LABEL_SELECTOR = "llm-d.ai/inferenceServing=true"


@dataclass
class PodReconcilerConfig:
    namespace: Optional[str] = None  # None = service-account namespace
    label_selector: str = DEFAULT_LABEL_SELECTOR
    socket_port: int = 5557
    # Subscriber ids are k8s namespaced names, not the engines'
    # published pod ids — match every kv topic on each pod's socket.
    topic_filter: str = "kv@"
    # Overrides for out-of-cluster use / tests; in-cluster values are
    # discovered from the environment and service-account files.
    api_server: Optional[str] = None
    token: Optional[str] = None
    ca_cert_path: Optional[str] = None
    reconnect_seconds: float = 5.0
    # Server-side watch expiry: the API server ends the stream after this
    # many seconds and the loop re-lists — the liveness bound that keeps a
    # half-open TCP connection (node failover, LB idle drop without FIN)
    # from blocking the reconciler forever.  The socket read timeout is
    # set slightly above it so it only trips on genuinely dead streams.
    watch_timeout_seconds: float = 240.0


class KubeClient:
    """The two API calls the reconciler needs: list + watch pods."""

    def __init__(self, config: PodReconcilerConfig) -> None:
        self.config = config
        self.api_server = config.api_server or self._in_cluster_server()
        self.token = config.token or self._read_service_account("token")
        self.namespace = config.namespace or self._read_service_account(
            "namespace"
        )
        self._ssl_context = self._build_ssl_context()

    @staticmethod
    def _in_cluster_server() -> str:
        host = os.environ.get("KUBERNETES_SERVICE_HOST")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        if not host:
            raise RuntimeError(
                "not in-cluster (KUBERNETES_SERVICE_HOST unset) and no "
                "api_server configured"
            )
        return f"https://{host}:{port}"

    @staticmethod
    def _read_service_account(name: str) -> Optional[str]:
        path = os.path.join(SERVICE_ACCOUNT_DIR, name)
        if os.path.isfile(path):
            with open(path) as handle:
                return handle.read().strip()
        return None

    def _build_ssl_context(self) -> Optional[ssl.SSLContext]:
        if not self.api_server.startswith("https"):
            return None
        ca_path = self.config.ca_cert_path or os.path.join(
            SERVICE_ACCOUNT_DIR, "ca.crt"
        )
        if os.path.isfile(ca_path):
            return ssl.create_default_context(cafile=ca_path)
        return ssl.create_default_context()

    def _open(self, path: str, timeout: Optional[float]):
        request = urllib.request.Request(self.api_server + path)
        if self.token:
            request.add_header("Authorization", f"Bearer {self.token}")
        return urllib.request.urlopen(
            request, timeout=timeout, context=self._ssl_context
        )

    def _pods_path(self, query: Dict[str, str]) -> str:
        namespace = self.namespace or "default"
        return (
            f"/api/v1/namespaces/{namespace}/pods?"
            + urllib.parse.urlencode(query)
        )

    def list_pods(self) -> dict:
        query = {"labelSelector": self.config.label_selector}
        with self._open(self._pods_path(query), timeout=30) as response:
            return json.load(response)

    def watch_pods(self, resource_version: str):
        """Yield watch events until the stream ends or errors."""
        watch_timeout = self.config.watch_timeout_seconds
        query = {
            "labelSelector": self.config.label_selector,
            "watch": "true",
            "resourceVersion": resource_version,
            "allowWatchBookmarks": "true",
            "timeoutSeconds": str(int(watch_timeout)),
        }
        # A healthy stream ends server-side at timeoutSeconds; the read
        # timeout sits above that so it fires only when the connection is
        # half-open and no FIN will ever arrive.
        with self._open(
            self._pods_path(query), timeout=watch_timeout + 60
        ) as response:
            for line in response:
                line = line.strip()
                if line:
                    yield json.loads(line)


class PodReconciler:
    """Keeps subscriber state converged with the live pod set."""

    def __init__(
        self,
        subscriber_manager: SubscriberManager,
        config: Optional[PodReconcilerConfig] = None,
        client: Optional[KubeClient] = None,
    ) -> None:
        self.config = config or PodReconcilerConfig()
        self.subscriber_manager = subscriber_manager
        self.client = client or KubeClient(self.config)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- predicates (pod_reconciler.go:135-158) --

    @staticmethod
    def _pod_key(pod: dict) -> str:
        # A list item can be a dict whose "metadata" is null/string/list;
        # the key computation runs outside _reconcile_safely (reconcile_list
        # marks pods "seen" regardless of reconcile outcome), so it must
        # never raise — one poison pod would wedge every resync.
        metadata = pod.get("metadata")
        if not isinstance(metadata, dict):
            metadata = {}
        return f"{metadata.get('namespace', '')}/{metadata.get('name', '')}"

    @staticmethod
    def should_subscribe(pod: dict) -> bool:
        """Running, has an IP, and Ready."""
        status = pod.get("status", {})
        if status.get("phase") != "Running":
            return False
        if not status.get("podIP"):
            return False
        return any(
            condition.get("type") == "Ready"
            and condition.get("status") == "True"
            for condition in status.get("conditions", [])
        )

    def _endpoint(self, pod: dict) -> str:
        ip = pod["status"]["podIP"].strip()
        if ":" in ip:  # IPv6
            ip = f"[{ip}]"
        return f"tcp://{ip}:{self.config.socket_port}"

    # -- reconciliation --

    def _reconcile_safely(
        self, event_type: str, pod: dict, context: str
    ) -> None:
        """The per-item poison-skip policy, shared by the list and watch
        paths: a pod that fails to reconcile is logged and skipped,
        never allowed to abort the cycle."""
        try:
            self.reconcile(event_type, pod)
        except Exception:  # noqa: BLE001 - per-item poison skip
            logger.warning(
                "skipping pod %s that failed to reconcile: %r",
                context,
                pod,
                exc_info=True,
            )

    def reconcile(self, event_type: str, pod: dict) -> None:
        key = self._pod_key(pod)
        if event_type == "DELETED":
            self.subscriber_manager.remove_subscriber(key)
            return
        if self.should_subscribe(pod):
            self.subscriber_manager.ensure_subscriber(
                key, self._endpoint(pod), topic_filter=self.config.topic_filter
            )
        else:
            self.subscriber_manager.remove_subscriber(key)

    def reconcile_list(self, pod_list: dict) -> str:
        """Full resync from a list response; returns its resourceVersion.

        Per-item poison skip like the watch path: one malformed pod in
        the list must not abort the resync — run_once re-lists FIRST
        every cycle, so an aborting item would wedge the reconciler for
        as long as it exists."""
        seen = set()
        if not isinstance(pod_list, dict):
            logger.warning("malformed pod list response %r", type(pod_list))
            pod_list = {}
        items = pod_list.get("items")
        if not isinstance(items, (list, tuple)):
            # Go serializes an empty slice as null; a proxy may mangle
            # worse.  A malformed items field must not raise — run_once
            # re-lists first every cycle, so raising here wedges the
            # reconciler (no watch ever starts) for as long as the
            # response shape persists.
            if items is not None:
                logger.warning("malformed pod list items %r", type(items))
            items = []
        for pod in items:
            if not isinstance(pod, dict):
                logger.warning("skipping malformed pod list item %r", pod)
                continue
            self._reconcile_safely("MODIFIED", pod, "list item")
            # Seen regardless of reconcile outcome: a pod PRESENT in the
            # list response must never be pruned below — a transient
            # ensure_subscriber failure would otherwise tear down that
            # pod's existing healthy subscription every resync.
            seen.add(self._pod_key(pod))
        for pod_id in self.subscriber_manager.active_pods():
            # "/" distinguishes reconciler-owned ids from manual ones
            # (e.g. the global-socket "local-subscriber").
            if "/" in pod_id and pod_id not in seen:
                self.subscriber_manager.remove_subscriber(pod_id)
        meta = pod_list.get("metadata")
        if not isinstance(meta, dict):
            meta = {}
        version = meta.get("resourceVersion", "0")
        return version if isinstance(version, str) else "0"

    # -- watch loop --

    def run_once(self) -> None:
        """One list+watch cycle (returns when the stream drops)."""
        resource_version = self.reconcile_list(self.client.list_pods())
        try:
            for event in self.client.watch_pods(resource_version):
                if self._stop.is_set():
                    return
                if not isinstance(event, dict):
                    # Valid JSON, wrong shape: skip the line rather than
                    # abort the watch (poison-pill philosophy of
                    # kvevents/pool.py; the stream itself is still
                    # framed correctly).
                    logger.warning("skipping malformed watch event %r", event)
                    continue
                kind = event.get("type", "")
                if kind == "BOOKMARK":
                    continue
                if kind == "ERROR":
                    # e.g. 410 Gone: resourceVersion too old -> re-list.
                    logger.info("watch error event %s; re-listing", event)
                    return
                obj = event.get("object", {})
                if not isinstance(obj, dict):
                    logger.warning("skipping malformed pod object %r", obj)
                    continue
                if obj.get("kind") not in (None, "Pod"):
                    continue
                self._reconcile_safely(kind, obj, "watch event")
        except (TimeoutError, socket.timeout):
            # Dead (half-open) stream: treat like a normal stream end and
            # let the loop re-list.  socket.timeout is only an alias of
            # TimeoutError from Python 3.10; catch both so older
            # interpreters get the quiet re-list too.
            logger.info("watch read timed out; re-listing")

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.run_once()
            except Exception as exc:
                logger.warning(
                    "pod watch failed (%s); retrying in %.0fs",
                    exc,
                    self.config.reconnect_seconds,
                )
            self._stop.wait(self.config.reconnect_seconds)

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="kvtpu-pod-reconciler", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

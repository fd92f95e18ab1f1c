"""In-process replica spawning — N FleetServers as one test-size cluster;
the port's copy of ``deeplearning4j_tpu/cluster/replica.py``, over the
port's ``FleetServer``. Replicas spawned in one process share its CUDA
context: a sticky device error in one ends them all.

A "replica" here is a :class:`~..fleet.http.FleetServer` with a cluster
identity, its own HTTP port, and its own :class:`FleetRegistry` — exactly
what one serving process would be in production, minus the process
boundary. The smoke drill and the cluster tests spawn two or three of
these in one Python process, put a :class:`~.router.ClusterRouter` in
front, and kill one mid-traffic.

:meth:`ReplicaHandle.kill` is the deliberately rude path: it closes the
listener *without* draining, so from the router's transport the replica
looks exactly like a crashed process (connection refused), and only then
reclaims the worker threads so the host test process stays hygienic.
:meth:`ReplicaHandle.stop` is the polite path (drain, then close).
"""

from __future__ import annotations

import logging

from ..fleet.http import FleetServer
from ..fleet.registry import FleetRegistry

log = logging.getLogger(__name__)


class ReplicaHandle:
    """One spawned replica: its server, registry, and address."""

    def __init__(self, replica_id: str, fleet: FleetRegistry,
                 server: FleetServer):
        self.replica_id = replica_id
        self.fleet = fleet
        self.server = server
        self.base_url = f"http://{server.host}:{server.port}"
        self._down = False

    def alive(self) -> bool:
        return not self._down

    def kill(self) -> None:
        """Crash-style death: the listener closes first (instant
        connection-refused for the router), in-flight work is abandoned,
        and worker threads are reclaimed afterwards purely for test-process
        hygiene — nothing observable waits on the drain."""
        if self._down:
            return
        self._down = True
        log.warning("killing replica %s (%s)", self.replica_id,
                    self.base_url)
        self.server.stop(drain=False)
        try:
            self.fleet.shutdown()
        except Exception:  # a killed replica owes nobody a clean drain
            log.exception("post-kill cleanup of %s", self.replica_id)

    def stop(self) -> None:
        """Graceful retirement: drain resident models, then close."""
        if self._down:
            return
        self._down = True
        self.server.stop(drain=True)


def spawn_replica(replica_id: str, fleet: FleetRegistry, *,
                  host: str = "127.0.0.1", port: int = 0,
                  chaos_admin: bool = False) -> ReplicaHandle:
    """Start one replica over ``fleet`` (caller builds/loads the registry)
    on its own port (``port=0`` auto-assigns) and return its handle."""
    server = FleetServer(fleet, host=host, port=port,
                         replica_id=replica_id, chaos_admin=chaos_admin)
    server.start()
    return ReplicaHandle(replica_id, fleet, server)

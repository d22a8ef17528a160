"""The deployment under test: one server agent as `dist/server.hcl` shapes
it with `bootstrap_expect = 1`, set up as the port's
`Agent._setup_cluster_server` sets one up (the RPC and raft listener, a
durable raft log from `make_log_store` under the data directory, gossip
membership that bootstraps raft), with the server's defaults except what
the configuration file lists."""

from __future__ import annotations

import os
import threading
import time


class Cluster:
    def __init__(self, cfg: dict, data_dir: str, device: str):
        from nomad_tpu_torch.raft.native_log import make_log_store
        from nomad_tpu_torch.rpc.cluster import ClusterServer
        from nomad_tpu_torch.server import ServerConfig

        dep = cfg["deployment"]
        sconf = ServerConfig(bootstrap_expect=dep["bootstrap_expect"],
                             device=device, **dep["server_config"])
        self.cs = ClusterServer(sconf, bind_addr="127.0.0.1", port=0)
        raft_dir = os.path.join(data_dir, "raft")
        os.makedirs(raft_dir, exist_ok=True)
        self.raft_dir = raft_dir
        self.log_store = make_log_store(raft_dir)
        self.cs.connect([], log_store=self.log_store)
        self.cs.start()
        self.cs.enable_gossip("portbench-server-1")
        self.server = self.cs.server
        # Leader, with the term's workers started (establish_leadership
        # starts them after raft reports the leadership).
        deadline = time.monotonic() + 60
        while not (self.server.is_leader()
                   and len(self.server.workers) >= sconf.num_schedulers):
            if time.monotonic() > deadline:
                raise RuntimeError("the server never became leader")
            time.sleep(0.005)

    @property
    def log_store_name(self) -> str:
        return type(self.log_store).__name__

    def register_nodes(self, nodes, clients: int) -> None:
        """Each node through the `Node.Register` endpoint, as its client
        would: `clients` threads register at once, each the next node
        not yet taken."""
        from nomad_tpu_torch.structs import to_dict

        handle = self.cs.endpoints.handle
        todo = iter(nodes)
        lock = threading.Lock()
        failed = []

        def client() -> None:
            while True:
                with lock:
                    node = next(todo, None)
                if node is None or failed:
                    return
                try:
                    handle("Node.Register", {"Node": to_dict(node)})
                except Exception as e:   # surfaces after the join
                    failed.append(e)
                    return

        threads = [threading.Thread(target=client, daemon=True,
                                    name=f"portbench-node-{i}")
                   for i in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if failed:
            raise failed[0]

    def shutdown(self) -> None:
        self.cs.shutdown()
        close = getattr(self.log_store, "close", None)
        if close is not None:
            close()

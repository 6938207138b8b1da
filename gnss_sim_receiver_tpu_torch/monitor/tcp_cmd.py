"""TCP telecommand interface, the port's copy of
``gnss_sim_receiver_tpu.monitor.tcp_cmd``.

Equivalent of the reference TcpCmdInterface
(src/core/receiver/tcp_cmd_interface.cc:46-176): a line-based TCP server
exposing status / standby / reset / coldstart / warmstart / hotstart on a
thread; each command goes to the receiver's control plane
(``ReceiverSession.on_command``, which runs its device work on the
session's device and default stream) and `status` reports the channels and
the last fix.
"""

from __future__ import annotations

import socket
import threading


class TcpCmdServer:
    """Line protocol: one command per line; each reply ends with '\\n'.
    Commands mirror tcp_cmd_interface.cc register_functions()."""

    def __init__(self, control, host: str = "127.0.0.1", port: int = 0):
        """`control` provides status_text() and on_command(name) -> reply
        string (the ControlThread event-queue role)."""
        self.control = control
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind((host, port))
        self.port = self.sock.getsockname()[1]
        self.sock.listen(4)
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def close(self) -> None:
        self._stop.set()
        try:
            # unblock accept()
            poke = socket.create_connection(("127.0.0.1", self.port),
                                            timeout=1)
            poke.close()
        except OSError:
            pass
        self.sock.close()

    def _serve(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            if self._stop.is_set():
                conn.close()
                return
            threading.Thread(target=self._handle, args=(conn,),
                             daemon=True).start()

    def _handle(self, conn: socket.socket) -> None:
        known = ("status", "standby", "reset", "coldstart", "warmstart",
                 "hotstart")
        with conn:
            fh = conn.makefile("rw", newline="\n")
            for line in fh:
                cmd = line.strip().lower()
                if not cmd:
                    continue
                if cmd == "exit":
                    return
                if cmd == "status":
                    reply = self.control.status_text()
                elif cmd in known:
                    reply = self.control.on_command(cmd)
                else:
                    reply = f"ERROR: unknown command [{cmd}]"
                fh.write(reply.rstrip("\n") + "\n")
                fh.flush()

"""The admin as a process: ``python -m rafiki_tpu_torch.admin``.

Seeds the superadmin, serves the REST door until SIGTERM or SIGINT, then
stops every job and exits 0. Settings, from the environment:

    RAFIKI_WORKDIR      params and store root         (default: cwd)
    RAFIKI_DB_PATH      store file     (default: WORKDIR/rafiki_torch.sqlite3)
    RAFIKI_ADMIN_HOST   bind host                     (default: 127.0.0.1)
    RAFIKI_ADMIN_PORT   bind port                     (default: 3000; 0 = any)

Services run as threads of this process on the visible CUDA devices, or
as child processes under ``RAFIKI_PLACEMENT=process``; it refuses to
start without a CUDA device. Under ``RAFIKI_PLACEMENT=hosts`` they run on
the host agents of ``RAFIKI_AGENTS`` (``python -m
rafiki_tpu_torch.placement.agent`` on each host, with the fleet's
``RAFIKI_AGENT_KEY``), and the admin itself needs no card.

On a store a dead admin left, the boot reconciles it (crash recovery) and
the banner says ``recovery=recovering``. Under ``RAFIKI_ADMIN_HA=1`` it
takes the leadership lease first (``LeaseNotAcquiredError`` while another
admin holds a live one: a standby is built from ``StandbyAdmin`` and
``AdminServer``, ``admin/standby.py``) and advertises its bound address
on the lease row, the leader hint of standby 503s.
"""

from __future__ import annotations

import logging
import os
import signal
import sys
import time


def main() -> int:
    logging.basicConfig(
        level=os.environ.get("RAFIKI_LOG_LEVEL", "INFO"),
        format="%(levelname)s:%(asctime)s:%(name)s: %(message)s")
    from rafiki_tpu_torch import config
    from rafiki_tpu_torch.admin.admin import Admin
    from rafiki_tpu_torch.admin.http import AdminServer
    from rafiki_tpu_torch.db.database import Database

    os.makedirs(config.PARAMS_DIR, exist_ok=True)
    admin = Admin(db=Database(config.DB_PATH))
    host = os.environ.get("RAFIKI_ADMIN_HOST", "127.0.0.1")
    port = int(os.environ.get("RAFIKI_ADMIN_PORT", "3000"))
    server = AdminServer(admin, host=host, port=port).start()
    if admin.lease is not None:
        # the address is known once bound; the next renewal carries it
        admin.lease.addr = f"{host}:{server.port}"
    rec = admin.recovery_status()
    rec_note = ("" if rec.get("state") == "ready" and not rec.get("scanned")
                else f", recovery={rec.get('state')}")
    print(f"rafiki_tpu_torch admin on http://{host}:{server.port} "
          f"(db={admin.db.path}, placement="
          f"{type(admin.placement).__name__}{rec_note})", flush=True)

    # the handler takes no lock (an Event.set() in a handler can deadlock
    # on the Event's own lock), and the wait wakes to look
    stop: list = []
    signal.signal(signal.SIGTERM, lambda *a: stop.append(a[0]))
    signal.signal(signal.SIGINT, lambda *a: stop.append(a[0]))
    try:
        while not stop:
            time.sleep(0.2)
    finally:
        print("shutting down...", flush=True)
        server.stop()
        admin.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())

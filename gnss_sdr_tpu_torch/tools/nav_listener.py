"""UDP monitor stream listener (reference utils/nav-listener analog).

Listens on the GnssSynchroMonitor / PVT monitor UDP port and prints a live
channel table. Works with both the binary struct and JSON-lines modes of
gnss_sdr_tpu_torch/monitor/sinks.py.

Run: python -m gnss_sdr_tpu_torch.tools.nav_listener [--port 1234]
     [--mode binary|json]
"""

from __future__ import annotations

import argparse
import socket
import time


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=1234)
    ap.add_argument("--mode", choices=("binary", "json"), default="binary")
    ap.add_argument("--interval", type=float, default=1.0,
                    help="table refresh seconds")
    args = ap.parse_args()

    from gnss_sdr_tpu_torch.monitor.synchro import decode_synchro

    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.bind(("0.0.0.0", args.port))
    sock.settimeout(0.2)
    print(f"listening on udp/{args.port} ({args.mode})", flush=True)

    chans: dict[int, dict] = {}
    last = time.time()
    while True:
        try:
            data, _ = sock.recvfrom(65536)
            if args.mode == "json":
                import json

                rec = json.loads(data.decode())
            else:
                s = decode_synchro(data)
                rec = s.__dict__
            chans[int(rec.get("channel_id", 0))] = rec
        except socket.timeout:
            pass
        except (ValueError, KeyError):
            continue
        if time.time() - last >= args.interval and chans:
            last = time.time()
            print("\nCH  SYS PRN   CN0[dBHz]  Doppler[Hz]      TOW[s]")
            for ch in sorted(chans):
                r = chans[ch]
                print(f"{ch:2d}  {r.get('system', '?'):>3} "
                      f"{int(r.get('prn', 0)):3d}   "
                      f"{float(r.get('cn0_db_hz', 0.0)):8.1f}  "
                      f"{float(r.get('carrier_doppler_hz', 0.0)):+11.1f}  "
                      f"{float(r.get('tow_at_current_symbol_ms', 0)) / 1e3:10.2f}",
                      flush=True)


if __name__ == "__main__":
    main()

"""A client process of the serve cells: sends its share of an open-loop
schedule of ``POST /tag`` requests, each on a connection of its own.

    python3 -m benchmark.serve_client <spec.json>

The spec gives the server's ``host`` and ``port``, the pool file (a .npy
of int16 clips), this client's ``requests`` ([id, due, clip], due in
seconds after the window opens), ``threads`` and ``timeout``, and the
``out`` file for the results. The client makes its WAV bodies, prints
``ready``, and waits for a line ``go <t0>`` on standard input, ``t0``
being the window's opening on the machine's monotonic clock (shared by
every process). A dispatcher thread hands each request to a pool of
senders at its due time, whether or not earlier ones have been answered.
Each result is [id, sent, received, status, indexes, probs] with times
on the same clock; status 0 means no answer (error or timeout).

Standard library and NumPy only.
"""

from __future__ import annotations

import http.client
import json
import queue
import struct
import sys
import threading
import time

import numpy as np


def wav_bytes(pcm: np.ndarray, rate: int = 32000) -> bytes:
    """A 16-bit mono PCM WAV file of ``pcm`` (int16)."""
    data = np.asarray(pcm, "<i2").tobytes()
    head = struct.pack("<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(data), b"WAVE", b"fmt ", 16,
                       1, 1, rate, rate * 2, 2, 16, b"data", len(data))
    return head + data


def post(host: str, port: int, body: bytes, timeout: float):
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("POST", "/tag", body, {"Content-Type": "audio/wav"})
        resp = conn.getresponse()
        data = resp.read()
        return resp.status, data
    finally:
        conn.close()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    with open(argv[0]) as f:
        spec = json.load(f)
    pool = np.load(spec["pool"], mmap_mode="r")
    reqs = spec["requests"]
    bodies = {c: wav_bytes(pool[c]) for c in sorted({r[2] for r in reqs})}
    results = {}
    lock = threading.Lock()
    work: "queue.Queue" = queue.Queue()

    def sender():
        while True:
            item = work.get()
            if item is None:
                return
            rid, clip = item
            sent = time.monotonic()
            status, idx, probs = 0, [], []
            try:
                code, data = post(spec["host"], spec["port"], bodies[clip], spec["timeout"])
                status = code
                if code == 200:
                    ans = json.loads(data)
                    idx, probs = ans["indexes"], ans["probs"]
            except Exception:  # noqa: BLE001 - counted as no answer
                status = 0
            with lock:
                results[rid] = [rid, sent, time.monotonic(), status, idx, probs]

    threads = [threading.Thread(target=sender, daemon=True) for _ in range(spec["threads"])]
    for t in threads:
        t.start()
    print("ready", flush=True)
    line = sys.stdin.readline().split()
    t0 = float(line[1])
    for rid, due, clip in reqs:
        delay = t0 + due - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        work.put((rid, clip))
    for _ in threads:
        work.put(None)
    for t in threads:
        t.join()
    with open(spec["out"], "w") as f:
        json.dump([results[r[0]] for r in reqs], f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

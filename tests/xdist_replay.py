"""Replay of pytest-xdist's ``--dist load`` scheduling (LoadScheduling of
xdist 3.x) on the per-test durations of a junit file: the wall time of
the tier-1 command at a given collection order, and at that order with
``extra`` skipped items (0.01 s each) appended to the port's last test
file, so that a PR can see what its item count does to the wall before
its whole run (ROADMAP, tier-1 time).  Each of the ``workers`` first
takes a chunk of (N // workers) // 4 consecutive items; then a worker
below len(pending) // workers // 4 items is topped up to // 2, unless
its last test took 0.1 s or more and it still holds two.

    python -m pytest tests/ -q -m 'not slow' --collect-only \\
        -p no:randomly > collected.txt
    python tests/xdist_replay.py JUNIT.xml collected.txt [EXTRA ...]

The file is not a test module: pytest does not collect it.
"""

import heapq
import sys
import xml.etree.ElementTree as ET


def durations(junit):
    """{(classname, name): seconds} of every testcase of a junit file."""
    return {(tc.get('classname'), tc.get('name')): float(tc.get('time') or 0)
            for tc in ET.parse(junit).getroot().iter('testcase')}


def junit_key(nodeid):
    """The junit (classname, name) of a pytest node id."""
    path, rest = nodeid.split('::', 1)
    parts = rest.split('::')
    return ('.'.join([path[:-3].replace('/', '.')] + parts[:-1]), parts[-1])


def replay(times, workers=6):
    """Wall seconds of the items' times run by ``workers`` xdist workers."""
    n = len(times)
    pending = list(range(n))
    queue = [[] for _ in range(workers)]
    chunk = max((n // workers) // 4, 2)
    for q in queue:
        q += pending[:chunk]
        del pending[:chunk]
    heap = [(times[q[0]], k) for k, q in enumerate(queue) if q]
    heapq.heapify(heap)
    wall = 0.0
    while heap:
        t, k = heapq.heappop(heap)
        last = queue[k].pop(0)
        wall = max(wall, t)
        if pending:
            low = max(2, len(pending) // workers // 4)
            high = max(2, len(pending) // workers // 2)
            q = queue[k]
            if len(q) < low and not (times[last] >= 0.1 and len(q) >= 2):
                take = high - len(q)
                q += pending[:take]
                del pending[:take]
        if queue[k]:
            heapq.heappush(heap, (t + times[queue[k][0]], k))
    return wall


def main(argv):
    took = durations(argv[1])
    ids = [line.strip() for line in open(argv[2]) if '::' in line]
    times = [took.get(junit_key(i), 0.05) for i in ids]
    missing = sum(junit_key(i) not in took for i in ids)
    print(f"{len(ids)} items ({missing} without a duration, taken as "
          f"0.05 s), {sum(times):.1f} s serial: wall {replay(times):.1f} s")
    at = max(k for k, i in enumerate(ids) if i.startswith('tests/test_torch'))
    for extra in map(int, argv[3:]):
        t = times[:at + 1] + [0.01] * extra + times[at + 1:]
        print(f"{len(t)} items (chunk {(len(t) // 6) // 4}): wall "
              f"{replay(t):.1f} s")


if __name__ == '__main__':
    main(sys.argv)

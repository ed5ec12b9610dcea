"""The share of a train cell's traced window in which no operation runs
on the card: one minus the union of the device records' intervals over
the window."""


def read(r):
    if r['workload']['entry'] != 'train' or r['trace']['window_s'] <= 0:
        return None
    tr = r['trace']
    return 100.0 * (1.0 - tr['busy_s'] / tr['window_s'])

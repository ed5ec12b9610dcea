"""Graceful-stop signal handling: the port's copy of
``joint_vae_tpu/utils/signaling.py`` (ref utils/signaling.py:5-31).

The train loop polls ``handler.sig`` between phases and stops with
increasing urgency (ref checks at cvae.py:2377,2405,2415,2495,2542):

- sig > 1: stop after the next full test
- sig > 2: stop after the current epoch (still saving)
- sig > 3: stop immediately, skip saving

SIGUSR1 sets level 2, SIGTERM sets 3; each SIGINT press adds 2 (so a second
Ctrl-C aborts hard)."""

import logging
import signal


class SIGHandler:
    def __init__(self, *signals):
        self.sig = 0
        self._names = []
        for s in signals:
            try:
                signal.signal(s, self)
                self._names.append(signal.Signals(s).name)
            except (ValueError, OSError):
                pass  # not in main thread / unsupported

    def __call__(self, signum, frame):
        if signum == getattr(signal, 'SIGUSR1', None):
            self.sig = max(self.sig, 2)
        elif signum == signal.SIGTERM:
            self.sig = max(self.sig, 3)
        elif signum == signal.SIGINT:
            self.sig += 2
        else:
            self.sig = max(self.sig, 2)
        logging.warning('Received signal %s (stop level %d)', signum, self.sig)

    def __str__(self):
        return 'SIGHandler(level={})'.format(self.sig)



def default_handler() -> SIGHandler:
    """A handler installed for SIGINT, SIGTERM and (where it exists)
    SIGUSR1."""
    sigs = [signal.SIGINT, signal.SIGTERM]
    if hasattr(signal, 'SIGUSR1'):
        sigs.append(signal.SIGUSR1)
    return SIGHandler(*sigs)

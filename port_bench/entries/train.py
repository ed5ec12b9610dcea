"""A training cell: ``train/trainer.py::train_model`` of the program,
host-fed through its loader, on a set made from the seed.

Set-up builds one job (model, optimizer state, generator) and hands it to
one call of the trainer, which pulls its metrics as it does on the card
(every 8 steps there).  Its steps up to the first pull are the compared
ones, run by that same call, its step graph, feed and pull: the trainer
reads its signal handler after every step, and there the benchmark takes
Adam's first moment after the first step and the weights after the
third (copies on the card, queued behind the step); at the first pull it
takes the mean loss that the trainer reports.  The window opens at that
pull (the step's graph is captured by then) and closes at the first pull
``--seconds`` later.  The reference follows the steps up to the first
pull once the window has closed and the program's state is freed.
"""

import sys
import time

import torch

from harness import compare, host, inputs, program
from reference import loader as ref_loader
from reference import steps as ref_steps

EPOCHS = 10 ** 6        # the trainer runs until the benchmark stops it


class _Signal:
    """The trainer's signal handler: a level above 3 stops it at once.
    The trainer reads it after every step, which is where the compared
    steps' state is taken."""

    def __init__(self, job, compared_steps: int):
        self.job, self.compared_steps = job, compared_steps
        self.level = 0
        self.first_moment = self.after = None

    @property
    def sig(self) -> int:
        st = self.job.state
        if st.step == 1 and self.first_moment is None:
            self.first_moment = {k: v.clone()
                                 for k, v in st.opt_state.mu.items()}
        if st.step == self.compared_steps and self.after is None:
            self.after = {k: p.detach().clone()
                          for k, p in self.job.model.named_parameters()}
        return self.level


class _Window:
    """The trainer's output.  At the first pull it records the mean loss
    that the trainer reports and opens the window; the window closes at
    the first pull ``seconds`` later, or, in a traced run, ``trace_steps``
    steps after the first pull."""

    def __init__(self, job, seconds: float, session=None,
                 trace_steps: int = 0):
        self.job, self.seconds = job, seconds
        self.session, self.trace_steps = session, trace_steps
        self.stop = _Signal(job, compare.COMPARED_STEPS)
        self.loss = self.pull_steps = None
        self.t0 = self.t1 = None
        self.step0 = self.step1 = None
        self.traced = None
        self.host = host.HostMeter()
        self.pulls = []                 # (seconds, step) at each pull

    def results(self, i, per_epoch, epoch, epochs, preambule='', losses=None,
                **_):
        now = time.perf_counter()
        step = self.job.state.step
        self.pulls.append((now, step))
        if self.t0 is None:
            self.loss, self.pull_steps = losses['total'], step
            self.t0, self.step0 = now, step
            self.host.start()
            if self.session is not None:
                self.session.open()
            return
        if self.session is not None:
            done = step - self.step0 >= self.trace_steps
            if done:
                self.traced = self.session.close()
        else:
            done = now - self.t0 >= self.seconds
        if done:
            self.t1, self.step1 = now, step
            self.host_use = self.host.stop()
            self.stop.level = 4

    def compared(self) -> dict:
        """What the comparison reads, on the host (after the window)."""
        st = self.stop
        if st.first_moment is None or st.after is None:
            raise RuntimeError('the trainer did not read its signal handler '
                               'after steps 1 and {}'.format(
                                   st.compared_steps))
        b1 = self.job.opt_cfg.betas[0]
        return {'loss': self.loss, 'steps': self.pull_steps,
                'first_grad': {k: (v / (1.0 - b1)).float().cpu()
                               for k, v in st.first_moment.items()},
                'after': program.canonical_params(self.job, st.after)}


def train_window(job, trainset, cfg: dict, batch_size: int, loader_seed: int,
                 seconds: float, session=None, trace_steps: int = 0,
                 metrics_every: int = 0) -> _Window:
    """One call of the trainer on ``job`` (``metrics_every`` 0: the
    trainer's own cadence) that stops once the window has closed."""
    win = _Window(job, seconds, session, trace_steps)
    program.train_model(job, trainset, epochs=EPOCHS, batch_size=batch_size,
                        data_augmentation=cfg['data_augmentation'],
                        signal_handler=win.stop, outputs=win,
                        seed=loader_seed, final_test=False, final_ood=False,
                        metrics_every=metrics_every)
    if win.t1 is None:
        raise RuntimeError('the trainer stopped before the window closed')
    if win.pull_steps < compare.COMPARED_STEPS:
        raise RuntimeError('the first pull came after {} steps, before the '
                           '{} compared'.format(win.pull_steps,
                                                compare.COMPARED_STEPS))
    return win


def run(ctx) -> dict:
    cfg, wl, dev = ctx.cfg, ctx.workload, ctx.device
    s = inputs.seeds(ctx.seed)
    batch = wl['batch_size']
    W = inputs.make_weights(cfg, s['weights'], dev)
    job = program.build_job(cfg, W, dev, s['noise'])
    del W
    x, y = inputs.make_train_set(cfg, wl['set_size'], s['data'], dev)
    trainset = program.ArrayDataset(x, y, cfg['dataset'])
    session = (ctx.trace_session('port_bench.train_model') if ctx.trace
               else None)
    win = train_window(job, trainset, cfg, batch, s['loader'], ctx.seconds,
                       session, wl.get('trace_steps', 0),
                       wl.get('metrics_every', 0))
    steps = win.step1 - win.step0
    # the rate over each fifth of the window and the host's use of it,
    # for a look at a run's spread
    edges = [win.t0 + k * (win.t1 - win.t0) / 5 for k in range(6)]
    marks = [next(p for p in win.pulls if p[0] >= e) for e in edges]
    print('window fifths, steps per second: {}'.format(
        [round((b[1] - a[1]) / (b[0] - a[0]), 1)
         for a, b in zip(marks[:-1], marks[1:]) if b[0] > a[0]]),
        file=sys.stderr)
    print('host over the window: {}'.format(win.host_use), file=sys.stderr)
    out = {'t0': win.t0, 'attempted': steps, 'failed': 0,
           'window_s': win.t1 - win.t0, 'steps': steps,
           'images': steps * batch, 'traced': win.traced,
           'memory_peak_bytes': ctx.memory_peak()}
    got = win.compared()
    n = got['steps']
    del job, trainset, win
    ctx.free_program()

    # the reference follows the steps up to the first pull, from the same
    # inputs
    W = inputs.make_weights(cfg, s['weights'], dev)
    flip, crop = ref_loader.augmentation(cfg['data_augmentation'],
                                         cfg['input_shape'][1])
    batches = [(torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev))
               for a, b in ref_loader.epoch_batches(x, y, batch, s['loader'],
                                                    0, n, flip, crop)]
    g = torch.Generator(device=dev).manual_seed(s['noise'])
    noise = [inputs.latent_noise(g, cfg['latent_sampling'], batch,
                                 cfg['latent_dim'], dev) for _ in range(n)]
    with ctx.reference_precision():
        want = ref_steps.adam_steps(W, cfg, batches, noise,
                                    after_step=compare.COMPARED_STEPS)
    leaves = {}
    out['numbers'] = compare.train_gaps(got, want, W, leaves)
    print('worst grad leaves: {}'.format(sorted(
        leaves['grad'].items(), key=lambda kv: -kv[1])[:3]), file=sys.stderr)
    out['compared_steps'] = n
    out['train_images_per_s'] = out['images'] / out['window_s']
    return out

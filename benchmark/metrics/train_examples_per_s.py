"""``train_examples_per_s``: examples of all the fits in the window over
the window's time on the host's clock.  An example is one (user, item)
interaction for factorization models and one sequence for sequence
models."""


def read(window):
    if window.traffic['entry'] != 'fit':
        return None
    return sum(c['work'] for c in window.calls) / window.window_s

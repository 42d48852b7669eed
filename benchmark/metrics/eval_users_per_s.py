"""``eval_users_per_s``: users (or test sequences) ranked in all the calls
of the window over the window's time on the host's clock."""


def read(window):
    if window.traffic['entry'] == 'fit':
        return None
    return sum(c['work'] for c in window.calls) / window.window_s

"""``materialize_routes.eval``: metric calls of the window that the route
query (``evaluation._route``) sent to the materialize path, from the port's
counter ``evaluation.MATERIALIZE_ROUTES``; 0 on the streaming path."""


def read(window):
    return window.counters.get('materialize_routes')

"""The kernels' launch counters, by name: each kernel wrapper counts its
launches in attributes of its own (``render_fwd.launches`` and the rest) and
registers them here when its module is imported, so the code that reads and
writes them (``render/graphs.py``'s capture and replay) names no kernel."""

from __future__ import annotations

# name -> (the wrapper's attributes, the counter's attribute, the key in it
# where that is a dict, else None)
_WHERE: dict = {}


def register(name: str, owner, attribute: str) -> None:
    """Count ``owner.<attribute>`` as ``name``, or, where it is a dict, each
    of its keys ``k`` as ``name.k``. The attribute is read at every use, so
    a counter assigned anew is still the one counted."""
    value = getattr(owner, attribute)
    for key in value if isinstance(value, dict) else [None]:
        _WHERE[name if key is None else f"{name}.{key}"] = (vars(owner), attribute, key)


def counts() -> dict:
    """Every registered counter's value, by name."""
    return {name: attrs[a] if key is None else attrs[a][key]
            for name, (attrs, a, key) in _WHERE.items()}


def restore(values: dict) -> None:
    """Set the counters named in ``values`` to their values there."""
    for name, n in values.items():
        attrs, a, key = _WHERE[name]
        if key is None:
            attrs[a] = n
        else:
            attrs[a][key] = n


def add(values: dict) -> None:
    """Add ``values`` (launches by name) to the counters."""
    for name, n in values.items():
        attrs, a, key = _WHERE[name]
        if key is None:
            attrs[a] += n
        else:
            attrs[a][key] += n

"""One module a store (a traffic file's ``store``): where the distinct
frames live and how each handover fetches one.  ``Store(sut)`` is built
after the system has made its frames; ``get(j)`` returns frame ``j`` in the
form the system's reader hands over; ``take(idx)`` what the check keeps of
handover ``idx``; ``check(kept)`` the store's own numbers, each
``(value, limit)``; ``close()`` removes what it wrote."""

"""Reflection-based JSON codec for plain-attribute model objects.

Reference parity: edl/utils/json_serializable.py:26 (Serializable). Objects
round-trip through ``to_json``/``from_json`` by reflecting over ``__dict__``;
nested Serializable members and lists of them are handled recursively via a
``_json_types`` hint: {attr_name: cls} or {attr_name: [cls]} for lists.
"""

import json


class Serializable(object):
    _json_types = {}

    def to_dict(self):
        out = {}
        for k, v in self.__dict__.items():
            if isinstance(v, Serializable):
                out[k] = v.to_dict()
            elif isinstance(v, (list, tuple)) and v and isinstance(
                    v[0], Serializable):
                out[k] = [x.to_dict() for x in v]
            else:
                out[k] = v
        return out

    def from_dict(self, d):
        for k, v in d.items():
            hint = self._json_types.get(k)
            if hint is None:
                setattr(self, k, v)
            elif isinstance(hint, list):
                setattr(self, k, [hint[0]().from_dict(x) for x in v])
            else:
                setattr(self, k, hint().from_dict(v))
        return self

    def to_json(self):
        return json.dumps(self.to_dict(), sort_keys=True)

    def from_json(self, s):
        return self.from_dict(json.loads(s))

    def __eq__(self, other):
        return type(self) is type(other) and self.to_dict() == other.to_dict()

    def __ne__(self, other):
        return not self.__eq__(other)

    def __str__(self):
        return self.to_json()

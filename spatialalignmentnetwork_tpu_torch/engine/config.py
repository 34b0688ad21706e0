"""Ordered attribute-bag configuration with JSON round-tripping.

The port's own copy of the JAX package's `engine/config.py`: attribute
order is remembered, dict-style access, `in` membership, JSON save/load.
A checkpoint's `config` entry is this JSON.
"""

import json


class Config:
    def __init__(self, **params):
        super().__setattr__("memo", [])
        for key, val in params.items():
            setattr(self, key, val)

    def __setattr__(self, name, value):
        if name not in self.memo:
            self.memo.append(name)
        super().__setattr__(name, value)

    def __delattr__(self, name):
        self.memo.remove(name)
        super().__delattr__(name)

    def __str__(self):
        return "class Config containing: " + str(self.to_dict())

    __repr__ = __str__

    def __getitem__(self, param):
        if param not in self.memo:
            raise KeyError(f"{param} not found, try {self.memo}")
        return getattr(self, param)

    def __contains__(self, item):
        return item in self.memo

    def get(self, item, default=None):
        return getattr(self, item) if item in self.memo else default

    def to_dict(self):
        return {k: getattr(self, k) for k in self.memo}

    def load(self, path):
        for k in list(self.memo):
            delattr(self, k)
        with open(path, "r") as f:
            for k, v in json.load(f).items():
                setattr(self, k, v)
        return self

    def save(self, path):
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)

"""Frames held in host memory, handed over as the system's reader returns
them; no parse."""


class Store:
    def __init__(self, sut):
        self.get = sut.frame

    def take(self, idx: int):
        return None

    def check(self, kept: dict) -> dict:
        return {}

    def close(self) -> None:
        pass

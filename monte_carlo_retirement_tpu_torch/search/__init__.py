from .driver import find_minimum_working_months

__all__ = ["find_minimum_working_months"]

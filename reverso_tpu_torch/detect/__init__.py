from .regions import Regions, parse_prompts, BaseDetector, StubDetector

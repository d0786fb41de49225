from . import (bert, bloom, clip, exaone4, falcon,  # noqa: F401
               gpt, gptneox, llama, mixtral)

"""MovieLens (reference python/paddle/dataset/movielens.py). Synthetic
fallback with the reference's slot structure for the recommender book test."""
from __future__ import annotations

from . import common

USER_COUNT = 944
MOVIE_COUNT = 1683
JOB_COUNT = 21
AGE_COUNT = 7
CATEGORY_COUNT = 18
TITLE_VOCAB = 5175


def max_user_id():
    return USER_COUNT - 1


def max_movie_id():
    return MOVIE_COUNT - 1


def max_job_id():
    return JOB_COUNT - 1


def age_table():
    return list(range(AGE_COUNT))


def movie_categories():
    return {f"c{i}": i for i in range(CATEGORY_COUNT)}


def get_movie_title_dict():
    return {f"t{i}": i for i in range(TITLE_VOCAB)}


def _reader_creator(split: str):
    def reader():
        g = common.rng("movielens", split)
        for _ in range(512):
            user_id = int(g.integers(1, USER_COUNT))
            gender = int(g.integers(0, 2))
            age = int(g.integers(0, AGE_COUNT))
            job = int(g.integers(0, JOB_COUNT))
            movie_id = int(g.integers(1, MOVIE_COUNT))
            categories = g.integers(0, CATEGORY_COUNT,
                                    size=int(g.integers(1, 4))).tolist()
            title = g.integers(0, TITLE_VOCAB,
                               size=int(g.integers(2, 8))).tolist()
            score = float(g.integers(1, 6))
            yield [user_id, gender, age, job, movie_id, categories, title, score]

    return reader


def train():
    return _reader_creator("train")


def test():
    return _reader_creator("test")

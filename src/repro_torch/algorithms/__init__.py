"""The paper's evaluation algorithms (§IV-A) on the port's R-like API:
summary, correlation, GLM (IRLS) and k-means.  svd_tall, pca, gmm, nmf and
naive_bayes come with the algorithms slice (ROADMAP A8)."""
from .summary import summary
from .correlation import correlation
from .kmeans import kmeans
from .glm import glm, glm_predict, glm_iteration_plan

__all__ = ["summary", "correlation", "kmeans", "glm", "glm_predict",
           "glm_iteration_plan"]
